"""The port's omega certificate (``core/compression.omega_certificate``)
against the reference's (``repro.core.compression.omega_certificate``).

Both draw the same threefry stream: the session's layout, which the port
follows from JAX's flag. Fields equal: name, d, omega, kind, qualifier,
d_test, trials, refuted. ``worst_ratio`` and ``bound`` within
``CERT_RTOL = 1e-6`` relative: they are float32 sums of the same terms in
another order, and the normals come through the port's erfinv, within a few
ulps of XLA's (``tests/test_torch_init.py``).

The nine compressors are the registry's probes of R10
(``comm_lint.registry_probes``), at a small d and at the main path's d,
619,570,176 (qwen1.5-0.5b's flat buffer). In the partitionable layout their
worst ratios are pinned to the reference's at that d."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro_torch.analysis.comm_lint import registry_probes  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import prng  # noqa: E402

CERT_RTOL = 1e-6
MAIN_D = 619_570_176
SAME = ("name", "d", "omega", "kind", "qualifier", "d_test", "trials",
        "refuted")
# the reference's worst ratios at MAIN_D in the partitionable layout (jax
# 0.9.0 on the CPU)
PARTITIONABLE_WORST = {"identity": 0.0, "topk": 0.975054, "randk": 1.0,
                       "sign": 0.999756, "qsgd": 0.735355,
                       "signtopk": 0.975182, "qstopk": 0.975239,
                       "signtop_frac": 0.329474, "signtopk_block": 0.584738}


def _reference(comp: tcomp.Compressor) -> jcomp.Compressor:
    """The reference operator with the port operator's fields."""
    kw = {f.name: getattr(comp, f.name) for f in dataclasses.fields(comp)
          if f.init and f.name != "name"}
    return jcomp.make_compressor(comp.name, **kw)


def assert_same(got, want):
    for f in SAME:
        assert getattr(got, f) == getattr(want, f), f
    for f in ("worst_ratio", "bound"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=CERT_RTOL, atol=0, err_msg=f)


def certify(comp, d, **kw):
    with prng.threefry_partitionable(jax.config.jax_threefry_partitionable):
        return tcomp.omega_certificate(comp, d, device="cpu", **kw)


PROBES = registry_probes()


@pytest.mark.parametrize("d", [1000, MAIN_D])
@pytest.mark.parametrize("comp", PROBES, ids=[c.name for c in PROBES])
def test_registry_certificates_equal_reference(comp, d):
    got = certify(comp, d)
    assert_same(got, jcomp.omega_certificate(_reference(comp), d))
    assert got.kind == "analytic" and not got.refuted
    assert got.trials == (6 if isinstance(comp, tcomp.TopFrac) else 7)


@pytest.fixture
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        with prng.threefry_partitionable(True):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("comp", PROBES, ids=[c.name for c in PROBES])
def test_main_path_certificates_in_the_partitionable_layout(partitionable,
                                                            comp):
    got = tcomp.omega_certificate(comp, MAIN_D, device="cpu")
    assert got.d_test == 4096 and not got.refuted
    assert got.worst_ratio == pytest.approx(
        PARTITIONABLE_WORST[comp.name], abs=5e-7)
    if comp.name == "signtopk_block":
        assert got.omega == 103 / 1024 and got.qualifier == "isotropic-proxy"


@dataclasses.dataclass(frozen=True)
class _Halve(tcomp.Compressor):
    """Keeps the base class's omega: its certificate is sampled."""

    name: str = "halve"

    def __call__(self, x, key=None):
        return 0.5 * x


@dataclasses.dataclass(frozen=True)
class _JHalve(jcomp.Compressor):
    name: str = "halve"

    def __call__(self, x, key=None):
        return 0.5 * x


@dataclasses.dataclass(frozen=True)
class _LyingSign(tcomp.Sign):
    """Claims omega = 1 (lossless) for the 1-bit quantizer."""

    def omega(self, d: int) -> float:
        return 1.0


@dataclasses.dataclass(frozen=True)
class _JLyingSign(jcomp.Sign):
    def omega(self, d: int) -> float:
        return 1.0


@pytest.mark.parametrize("d", [64, 5000])
def test_undeclared_omega_is_sampled(d):
    got = certify(_Halve(), d)
    assert_same(got, jcomp.omega_certificate(_JHalve(), d))
    assert got.kind == "sampled" and not got.refuted
    assert got.omega == pytest.approx(0.375)    # (1 - 0.25) / 2


@pytest.mark.parametrize("d", [64, 5000])
def test_lying_omega_is_refuted(d):
    got = certify(_LyingSign(), d)
    assert_same(got, jcomp.omega_certificate(_JLyingSign(), d))
    assert got.refuted and got.kind == "analytic"


def test_certificate_options_equal_reference():
    comp = tcomp.QSGD(s=4, scaled=False)
    kw = dict(d_test=512, trials=3, key_draws=2, tol=0.0, seed=7)
    got = certify(comp, 2048, **kw)
    assert_same(got, jcomp.omega_certificate(_reference(comp), 2048, **kw))
    assert got.trials == 4 and got.d_test == 512


def test_cuda_default_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tcomp.omega_certificate(tcomp.Sign(), 64)
