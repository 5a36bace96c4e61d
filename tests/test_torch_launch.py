"""The port's launcher and mesh arguments: a rank that raises or outlives
the group's time limit makes ``spawn`` raise (and no rank is left
running); NCCL is refused where it cannot run, with no fall back to gloo;
a batch splits into the JAX layer's contiguous blocks."""
import numpy as np
import pytest
import torch

from nerfacc_tpu_torch.parallel import dryrun, launch, mesh, spawn
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


def test_spawn_runs_only_the_ports_functions():
    with pytest.raises(ValueError, match="functions of nerfacc_tpu_torch"):
        spawn(2, np.sum, device="cpu")


def test_a_failing_rank_fails_the_group():
    """A dry run of 3 ranks asked of 2: each rank raises, and spawn reports
    the rank's traceback."""
    with pytest.raises(RuntimeError, match="the dry run of 3 ranks runs on 2"):
        spawn(2, dryrun.dryrun_rank, 3, backend="gloo", device="cpu", timeout=60)


def test_a_rank_past_the_time_limit_fails_the_group():
    """Ranks still starting after 1 s: spawn stops them and raises."""
    with pytest.raises(TimeoutError, match="outlived"):
        spawn(2, dryrun.dryrun_rank, 2, backend="gloo", device="cpu", timeout=1)


@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
def test_nccl_is_refused_where_it_cannot_run(device):
    """NCCL on the CPU, and NCCL with two ranks over fewer than two cards
    (here none): both raise before any process group forms."""
    with pytest.raises(ValueError, match="NCCL"):
        mesh.make_mesh(2, 0, "tcp://127.0.0.1:1", backend="nccl", device=device)


def test_no_card_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(1, 0, "tcp://127.0.0.1:1")


def test_shard_batch_takes_contiguous_blocks():
    """JAX's ``P(axis)`` placement: rank r of n takes rows [r n_local, (r +
    1) n_local); ``color_bkgd`` whole; a model group's ranks share a block."""
    batch = {"rays_o": np.arange(24, dtype=np.float32).reshape(8, 3),
             "color_bkgd": np.ones(3, np.float32)}
    for n_data, n_model in ((2, 1), (4, 1), (2, 2)):
        for rank in range(n_data * n_model):
            d = rank // n_model
            view = mesh.Mesh(None, rank, n_data * n_model, torch.device("cpu"), "gloo", None, d,
                             n_data, None, rank % n_model, n_model)
            out = mesh.shard_batch(batch, view)
            block = 8 // n_data
            np.testing.assert_array_equal(out["rays_o"].numpy(),
                                          batch["rays_o"][d * block : (d + 1) * block])
            np.testing.assert_array_equal(out["color_bkgd"].numpy(), batch["color_bkgd"])
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_batch(batch, mesh.Mesh(None, 0, 3, torch.device("cpu"), "gloo", None, 0, 3))


def test_to_numpy_walks_results():
    out = launch.to_numpy({"a": [torch.ones(2), (torch.zeros(1, dtype=torch.bfloat16), 3)]})
    assert isinstance(out["a"][0], np.ndarray) and out["a"][1][0].dtype == np.float32
    assert out["a"][1][1] == 3
