from .model_zoo import ModelBundle, bundle  # noqa: F401
from .transformer import Model  # noqa: F401
