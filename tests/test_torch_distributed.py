"""The port's sharded train step on gloo ranks (CPU) for reduced
smollm-135m: on the meshes (data 4) with fsdp, (data 2, model 2) and
(model 4), and one microbatched step (microbatch 2 of batch 8 over data 2),
held to the port's unsharded step and to the reference's jitted sharded
step on the same mesh shape (Auto axes), from the same initial weights:

  * the loss within 1e-5 relative;
  * every gradient leaf, gathered whole, within 1e-4 of the leaf's max;
  * every parameter after 2 AdamW steps within 1e-4 of the leaf's max:
    with f32 moments all of them; with int8 moments those outside the rows
    where an int8 code differed, the codes within one of each other and
    fewer than 1 in 500 different (``torch_dist_support.check_int8``);
  * the 2 steps' losses within 1e-5 relative.

Plus ``shard_batch``'s rows on each rank."""
import pytest
import torch

import torch_dist_support as sup

CASES = {
    "data4": {"mesh": ((4,), ("data",)), "fsdp": True},
    "data2_model2": {"mesh": ((2, 2), ("data", "model")), "fsdp": True},
    "model4": {"mesh": ((1, 4), ("data", "model")), "fsdp": True},
    "micro2_data2": {"mesh": ((2, 2), ("data", "model")), "fsdp": True, "microbatch": 2},
}
ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return sup.run_parity(tmp_path_factory.mktemp("dist"), ARCH, CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches(runs, name):
    sup.check_loss(*runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match(runs, name):
    sup.check_grads(*runs, name)


@pytest.mark.parametrize("moment", ["float32", "int8"])
@pytest.mark.parametrize("name", list(CASES))
def test_params_after_two_steps_match(runs, name, moment):
    sup.check_params(*runs, name, moment)


def _shard_batch_rank(rank, world, out_dir):
    from repro_torch.training import data as tdata

    m = sup.mesh((2, 2), ("data", "model"))
    dcfg = tdata.DataConfig(vocab_size=256, seq_len=8, global_batch=6, seed=3)
    batch = tdata.get_batch(dcfg, 5, device="cpu")
    sb = tdata.shard_batch(batch, m)
    rows = sb["tokens"].to_local()
    r = m.get_local_rank("data")
    assert torch.equal(rows, batch["tokens"][3 * r:3 * (r + 1)])
    assert torch.equal(sb["tokens"].full_tensor(), batch["tokens"])
    torch.save(rows, f"{out_dir}/rows{rank}.pt")


def test_shard_batch_keeps_each_ranks_rows(tmp_path):
    sup.spawn(_shard_batch_rank, 4, tmp_path, str(tmp_path))
    rows = [torch.load(tmp_path / f"rows{r}.pt") for r in range(4)]
    assert torch.equal(rows[0], rows[1]) and torch.equal(rows[2], rows[3])
    assert not torch.equal(rows[0], rows[2])
