"""On the card: each CUDA kernel of the port against its plain PyTorch
version, and the main path on the card against the CPU.  Every test here is
marked ``gpu`` and skips where there is no CUDA device (decided in the
``cuda`` fixture).  This file imports torch and the port only, so it also
runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.common import NEG_INF
from repro_torch.core import SelectionSpec, backend_name, solve
from repro_torch.core.optimizers.backends import KERNEL_MIN_N
from repro_torch.interop import facility_location_from_arrays, result_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.fl_gains import fl_gains_at_plain, fl_gains_plain
from repro_torch.kernels.similarity_kernel import similarity_plain

pytestmark = pytest.mark.gpu

METRICS = ["dot", "cosine", "euclidean", "rbf"]
# the JAX package's bars for its similarity kernels: fp32 dot products
# summed in another order; euclidean / rbf pass through xx + yy - 2<x,y>
SIM_TOL = {
    "dot": (1e-4, 1e-3),
    "cosine": (1e-4, 1e-3),
    "euclidean": (1e-3, 5e-2),
    "rbf": (1e-3, 5e-2),
}
OPTIMIZERS = [
    ("NaiveGreedy", {}),
    ("LazyGreedy", {"screen_k": 1}),
    ("LazyGreedy", {"screen_k": 8}),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1000, 777, 130), (256, 384, 512), (1, 3, 1)])
@pytest.mark.parametrize("metric", METRICS)
def test_similarity_kernel_matches_plain(cuda, shape, metric):
    n, m, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, d), generator=g, device=cuda)
    y = torch.randn((m, d), generator=g, device=cuda)
    before = ops.LAUNCHES["similarity"]
    got = ops.similarity(x, y, metric)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["similarity"] == before + 1
    rtol, atol = SIM_TOL[metric]
    torch.testing.assert_close(got, similarity_plain(x, y, metric), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", [(4096, 4096), (1000, 777), (333, 5000), (129, 1)])
def test_fl_gains_kernels_match_plain(cuda, shape):
    """Kernel and plain version add in the same order: equal bit for bit,
    and the gathered kernel equals the full kernel at the same index."""
    u, n = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    sim = torch.rand((u, n), generator=g, device=cuda)
    cm = 0.8 * torch.rand((u,), generator=g, device=cuda)
    before = dict(ops.LAUNCHES)
    full = ops.fl_gains(sim, cm)
    torch.cuda.synchronize()
    assert torch.equal(full, fl_gains_plain(sim, cm))
    for k in (1, 8, 100, 777):
        idx = torch.randint(0, n, (k,), generator=g, device=cuda)
        idx[::7] = -1
        got = ops.fl_gains_at(sim, cm, idx)
        torch.cuda.synchronize()
        keep = idx >= 0
        assert torch.equal(got[keep], full[idx[keep]])
        assert bool((got[~keep] == NEG_INF).all())
        assert torch.equal(got, fl_gains_at_plain(sim, cm, idx))
    assert ops.LAUNCHES["fl_gains"] == before["fl_gains"] + 1
    assert ops.LAUNCHES["fl_gains_at"] == before["fl_gains_at"] + 4


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    s = torch.rand((8, 8), device=cuda)
    with pytest.raises(TypeError):
        ops.fl_gains(s.half(), torch.rand(8, device=cuda).half())
    with pytest.raises(ValueError, match="devices"):
        ops.fl_gains(s, torch.rand(8))


def test_argmax_takes_the_first_maximum_on_the_card(cuda):
    x = torch.tensor([0.5, 2.0, -1.0, 2.0, 2.0] * 1000, device=cuda)
    assert int(torch.argmax(x)) == 1


@pytest.mark.parametrize("optimizer,params", OPTIMIZERS)
def test_card_solve_equals_cpu_kernel_order(cuda, optimizer, params):
    """On the card the path runs the CUDA sweeps; their plain versions add
    in the same order, so over one similarity the card's selection equals
    the CPU's use_kernel=True selection exactly."""
    rng = np.random.default_rng(9)
    sim = rng.uniform(0, 1, size=(300, KERNEL_MIN_N)).astype(np.float32)
    gpu_fn = facility_location_from_arrays(sim, use_kernel=None, device="cuda")
    assert backend_name(gpu_fn) == "cuda-fl"
    cpu_fn = facility_location_from_arrays(sim, use_kernel=True, device="cpu")
    got = result_to_numpy(solve(SelectionSpec(gpu_fn, 30, optimizer, **params)))
    want = result_to_numpy(solve(SelectionSpec(cpu_fn, 30, optimizer, **params)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
