"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and nvcc and skips without
them; run them on the card with

    PYTHONPATH=src python -m pytest -m cuda -q tests/test_torch_cuda.py

Tolerances are those of ``repro_torch.kernels.parity``: for SignTopK, index
sets and thresholds exact, values within a few float32 ulps (one bfloat16
ulp); for QSGD, the same value tolerances except one-level flips where the
fraction or the noise lies within 4 ulps of a rounding boundary."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compression import BlockTopFrac  # noqa: E402
from repro_torch.kernels import parity  # noqa: E402
from repro_torch.kernels.qsgd import qsgd_blocks  # noqa: E402
from repro_torch.kernels.sign_topk import sign_topk_blocks  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("spec", parity.SIGN_TOPK_CASES,
                         ids=["-".join(map(str, s))
                              for s in parity.SIGN_TOPK_CASES])
def test_sign_topk_kernel_matches_plain(cuda, spec):
    before = sign_topk_blocks.launches
    parity.check_sign_topk(*parity.make_sign_topk_case(spec, cuda),
                           spec=spec)
    torch.cuda.synchronize()
    assert sign_topk_blocks.launches == before + 1


def test_sign_topk_ensemble_matches_rows(cuda):
    parity.check_ensemble_matches_rows(cuda)


def test_sign_topk_payload_reconstructs(cuda):
    parity.check_payload_reconstructs(cuda)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 1024), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        sign_topk_blocks(x, None, 1.0, 8)
    x = torch.zeros((2, 512), device=cuda)
    with pytest.raises(ValueError):
        sign_topk_blocks(x, None, 1.0, 8)
    with pytest.raises(ValueError):
        sign_topk_blocks(torch.zeros((2, 1024), device=cuda), None, 1.0, 0)


def test_failed_build_raises_instead_of_falling_back(cuda, monkeypatch):
    """A CUDA tensor never reaches the plain version: when the kernel cannot
    be built, the wrapper raises."""
    from repro_torch import kernels

    def broken():
        raise kernels.KernelBuildError("nvcc refused the source")
    kernels.library.cache_clear()
    monkeypatch.setattr(kernels, "build", broken)
    try:
        with pytest.raises(kernels.KernelBuildError):
            sign_topk_blocks(torch.ones((2, 1024), device=cuda), None, 1.0, 8)
    finally:
        kernels.library.cache_clear()


def test_sign_topk_kernel_matches_plain_chunked(cuda):
    """One launch over many tiles held against the plain version chunk by
    chunk, as ``chip_smoke.py`` holds the main path's full shape."""
    x = torch.randn((3 * 1000 + 7, 1024), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    x[5], x[6] = 1.0, 0.0
    before = sign_topk_blocks.launches
    parity.check_sign_topk_chunked(x, 103, chunk_rows=1000)
    torch.cuda.synchronize()
    assert sign_topk_blocks.launches == before + 1


@pytest.mark.parametrize("spec", parity.QSGD_CASES,
                         ids=["-".join(map(str, s))
                              for s in parity.QSGD_CASES])
def test_qsgd_kernel_matches_plain(cuda, spec):
    before = qsgd_blocks.launches
    parity.check_qsgd(*parity.make_qsgd_case(spec, cuda), spec=spec)
    torch.cuda.synchronize()
    assert qsgd_blocks.launches == before + 1


def test_qsgd_ops_ragged_and_unbiased(cuda):
    before = qsgd_blocks.launches
    parity.check_ops_qsgd_ragged(cuda)
    parity.check_qsgd_unbiased(cuda)
    assert qsgd_blocks.launches == before + len(parity.QSGD_RAGGED_D) + 256


def test_qsgd_kernel_matches_plain_chunked(cuda):
    x = torch.randn((2 * 1000 + 3, 1024), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    x[7] = 0.0
    u = torch.rand(x.shape, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(2))
    parity.check_qsgd_chunked(x, u, 16, chunk_rows=1000)


def test_qsgd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    u = torch.rand((2, 1024), device=cuda)
    with pytest.raises(TypeError):
        qsgd_blocks(torch.zeros((2, 1024), dtype=torch.float16, device=cuda),
                    u, 16)
    with pytest.raises(TypeError):
        qsgd_blocks(torch.zeros((2, 1024), device=cuda), u.double(), 16)
    with pytest.raises(ValueError):
        qsgd_blocks(torch.zeros((2, 512), device=cuda), u[:, :512], 16)
    with pytest.raises(ValueError):
        qsgd_blocks(torch.zeros((2, 1024), device=cuda), u[:1], 16)
    with pytest.raises(ValueError):
        qsgd_blocks(torch.zeros((1024, 2), device=cuda).t(), u, 16)
    with pytest.raises(ValueError):
        qsgd_blocks(torch.zeros((2, 1024), device=cuda), u.cpu(), 16)
    with pytest.raises(ValueError):
        qsgd_blocks(torch.zeros((2, 1024), device=cuda), u, 0)


def test_failed_qsgd_build_raises_instead_of_falling_back(cuda, monkeypatch):
    from repro_torch import kernels

    def broken():
        raise kernels.KernelBuildError("nvcc refused qsgd.cu")
    kernels.library.cache_clear()
    monkeypatch.setattr(kernels, "build", broken)
    try:
        with pytest.raises(kernels.KernelBuildError):
            qsgd_blocks(torch.ones((2, 1024), device=cuda),
                        torch.rand((2, 1024), device=cuda), 16)
    finally:
        kernels.library.cache_clear()


def test_block_top_frac_launches_the_kernel(cuda):
    x = torch.tensor(np.random.default_rng(3).standard_normal(2500),
                     dtype=torch.float32)
    comp = BlockTopFrac(frac=0.1)
    before = sign_topk_blocks.launches
    got = comp(x.to(cuda))
    torch.cuda.synchronize()
    assert sign_topk_blocks.launches == before + 1
    torch.testing.assert_close(got.cpu(), comp(x), rtol=1e-5, atol=0)


def test_reference_engine_on_the_card_matches_the_cpu(cuda):
    """SPARQ with BlockTopFrac on a small convex problem (n=6, d=1280, zero
    threshold, a sync every 5 of 40 steps): on the card one SignTopK launch
    per sync; integer channels and bits equal to the CPU run, losses within
    rtol 1e-4 (the gradients' sums round differently on the card)."""
    from repro_torch.core import prng, schedule, sparq, topology, triggers
    from repro_torch.data import synthetic

    X, Y = synthetic.convex_dataset(6, 40, n_features=64, n_classes=20)
    _, make_grad_fn, full_loss = synthetic.logistic_loss_and_grad(20)
    cfg = sparq.SparqConfig(topology=topology.make_topology("ring", 6),
                            compressor=BlockTopFrac(frac=0.1),
                            threshold=triggers.zero(),
                            lr=schedule.decaying(1.0, 50.0), H=5, gamma=0.3)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        Xt, Yt = torch.tensor(X, device=dev), torch.tensor(Y, device=dev)
        before = sign_topk_blocks.launches
        state, trace = sparq.run(cfg, make_grad_fn(Xt, Yt, 4),
                                 torch.zeros(1280, device=dev), 40,
                                 prng.PRNGKey(0), record_every=10,
                                 eval_fn=lambda xb: full_loss(xb, Xt, Yt))
        runs[dev.type] = state, trace, sign_topk_blocks.launches - before
    (sg, tg, lg), (sc, tc, lc) = runs["cuda"], runs["cpu"]
    assert lg == sg.sync_rounds == 8 and lc == 0
    assert [r[:2] + r[3:] for r in tg] == [r[:2] + r[3:] for r in tc]
    np.testing.assert_allclose([r[2] for r in tg], [r[2] for r in tc],
                               rtol=1e-4)
