"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and nvcc and skips without
them; run them on the card with

    PYTHONPATH=src python -m pytest -m cuda -q tests/test_torch_cuda.py

Tolerances are those of ``repro_torch.kernels.parity``: index sets and
thresholds exact, values within a few float32 ulps (one bfloat16 ulp)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import parity  # noqa: E402
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
