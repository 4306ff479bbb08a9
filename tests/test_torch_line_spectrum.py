"""The Fourier-slice sampler on the complex spectrum
(``ops/line_sample.py:sample_spectrum``), on the CPU:

(a) its plain version against a JAX composition of wire_tpu's own steps
    (``jnp.fft.fftshift``, the centring phase as
    wire_tpu/operators/radon.py:_radon_fourier forms it, the ``mode="wrap"``
    halo of 2, ``sample_lines_xla`` and the un-centring), forward and VJP,
    at an even and an odd P;
(b) a plain model of the CUDA kernels' index map, taps read straight from
    the unshifted plane through (y mod P - P//2) mod P and the adjoint as an
    ``index_add_`` with the conjugate phases, against the plain version and
    its autograd, at even and odd P with samples on the Nyquist line
    (positions P and P + 1);
(c) ``csrc/line_sample.cu`` itself, built by g++ through
    ``tools/host_rehearse.py`` (atomics under a mutex, one thread per CUDA
    thread) and driven through the wrapper's C interface, against the plain
    version at tiny even and odd P;
(d) the wrapper's CUDA branch refusing what the kernels do not take, with a
    tensor subclass that reports a CUDA device (no kernel runs).

Tolerance 1e-5 x max: (a) the two frameworks round the centring phase
(|phase| up to ~250 rad at P = 81) and their sums apart; (b) and (c) sum
the same terms in another order."""
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wire_tpu.ops.pallas import line_sample as JLS

from wire_tpu_torch.operators import radon as TR
from wire_tpu_torch.ops import line_sample as LS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5


def _host_rehearse():
    spec = importlib.util.spec_from_file_location(
        "host_rehearse", os.path.join(ROOT, "tools", "host_rehearse.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


H = _host_rehearse()


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


def _jax_slice(P, gy, gx):
    """(re, im) of the spectrum -> (re, im) of the slice, in JAX, as
    wire_tpu/operators/radon.py:_radon_fourier composes it with
    sampler='xla'."""
    c = (P - 1) / 2.0

    def fn(fr, fi):
        F = jnp.fft.fftshift(jax.lax.complex(fr, fi))
        f = ((jnp.arange(P) - P // 2) / P).astype(jnp.float32)
        F = F * jnp.exp(2j * jnp.pi * (f[:, None] + f[None, :]) * c)
        Fh = jnp.pad(F, ((0, 2), (0, 2)), mode="wrap")
        sre, sim = JLS.sample_lines_xla(jnp.real(Fh), jnp.imag(Fh), gy, gx)
        kx = jnp.fft.rfftfreq(P).astype(jnp.float32)
        s = jax.lax.complex(sre, sim) * jnp.exp(-2j * jnp.pi * kx * c)[None]
        return jnp.real(s), jnp.imag(s)
    return fn


@pytest.mark.parametrize("P", [64, 81])
def test_plain_matches_the_jax_composition(P):
    F, centre, gy, gx, uncentre, cot = H.line_sample_case(P, 12, P)
    fr, fi = (t.numpy() for t in (F.real, F.imag))
    cr, ci = (t.numpy() for t in (cot.real, cot.imag))
    a = torch.tensor(fr, requires_grad=True)
    b = torch.tensor(fi, requires_grad=True)
    s = LS.sample_spectrum_plain(torch.complex(a, b), centre, gy, gx,
                                 uncentre)
    got = (s.real, s.imag)
    grads = torch.autograd.grad(got, (a, b),
                                (torch.tensor(cr), torch.tensor(ci)))
    want, vjp = jax.vjp(_jax_slice(P, jnp.asarray(gy.numpy()),
                                   jnp.asarray(gx.numpy())),
                        jnp.asarray(fr), jnp.asarray(fi))
    for g, w in zip(got, want):
        _assert_close(g.detach().numpy(), w)
    for g, w in zip(grads, vjp((jnp.asarray(cr), jnp.asarray(ci)))):
        _assert_close(g.numpy(), w)


def _index_map_model(F, centre, gy, gx, uncentre, cot):
    """The kernels' arithmetic in PyTorch: each tap reads the unshifted F at
    ((y mod P) - P//2) mod P and the centring table at y mod P (x likewise);
    the adjoint adds conj(uncentre) w conj(centre) cot there.  Returns (the
    slice, the gradient of F)."""
    P = F.shape[0]
    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy, wx = gy - y0, gx - x0
    y0, x0 = y0.long(), x0.long()
    flat_f, flat_c = F.reshape(-1), centre.reshape(-1)
    v = torch.conj(uncentre) * cot
    out = torch.zeros_like(cot)
    f_bar = torch.zeros(P * P, dtype=F.dtype)
    for dy, w_y in ((0, 1 - wy), (1, wy)):
        for dx, w_x in ((0, 1 - wx), (1, wx)):
            ym, xm = (y0 + dy) % P, (x0 + dx) % P
            u = ((ym - P // 2) % P) * P + (xm - P // 2) % P
            ph = flat_c[ym * P + xm]
            w = w_y * w_x
            out = out + w * ph * flat_f[u]
            f_bar.index_add_(0, u.reshape(-1),
                             (w * torch.conj(ph) * v).reshape(-1))
    return out * uncentre, f_bar.reshape(P, P)


@pytest.mark.parametrize("P,A", [(16, 7), (27, 6), (64, 9)])
def test_kernel_index_map_matches_plain(P, A):
    F, centre, gy, gx, uncentre, cot = H.line_sample_case(P, A, P + 1)
    # the hand-put last row reaches lines P and P + 1
    assert float(gy.max()) >= P and float(gx.max()) >= P
    x = F.clone().requires_grad_(True)
    want = LS.sample_spectrum_plain(x, centre, gy, gx, uncentre)
    (want_bar,) = torch.autograd.grad(want, x, cot)
    got, got_bar = _index_map_model(F, centre, gy, gx, uncentre, cot)
    _assert_close(torch.view_as_real(got), torch.view_as_real(want.detach()))
    _assert_close(torch.view_as_real(got_bar), torch.view_as_real(want_bar))


@pytest.fixture(scope="module")
def host_line_sample(tmp_path_factory):
    LS._lib.cache_clear()
    with H.host_library("line_sample",
                        str(tmp_path_factory.mktemp("line_sample"))):
        yield
    LS._lib.cache_clear()


@pytest.mark.parametrize("P,A", H.LINE_SAMPLE_CASES)
def test_cuda_source_on_the_host_matches_plain(host_line_sample, P, A):
    before = dict(LS.launches)
    rel = H.line_sample_vs_plain(P, A, P)
    assert {k: LS.launches[k] - before[k] for k in before} == {
        "gather": 1, "scatter": 1}
    assert rel <= REL, rel


class _OnCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_inputs(P=9, A=3):
    F, centre, gy, gx, uncentre, _ = H.line_sample_case(P, A, 0)
    return [t.as_subclass(_OnCuda) for t in (F, centre, gy, gx, uncentre)]


@pytest.mark.parametrize("what,change,error", [
    ("angles", lambda xs: xs[2].requires_grad_(True), ValueError),
    ("gx grad", lambda xs: xs[3].requires_grad_(True), ValueError),
    ("strided F", lambda xs: xs.__setitem__(0, xs[0].t()), ValueError),
    ("real F", lambda xs: xs.__setitem__(0, xs[0].real.contiguous()),
     TypeError),
    ("uncentre shape", lambda xs: xs.__setitem__(4, xs[4][:, :-1]),
     ValueError)])
def test_cuda_branch_refuses_what_the_kernels_do_not_take(
        monkeypatch, what, change, error):
    calls = []
    monkeypatch.setattr(LS._SampleSpectrum, "apply",
                        lambda *xs: calls.append(xs))
    xs = _cuda_inputs()
    LS.sample_spectrum(*xs)
    assert len(calls) == 1 and all(a is b for a, b in zip(calls[0], xs))
    change(xs)
    with pytest.raises(error):
        LS.sample_spectrum(*xs)
    assert len(calls) == 1
