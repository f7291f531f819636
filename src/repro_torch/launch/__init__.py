"""Entry points: ``serve`` (continuous-batching engine)."""
