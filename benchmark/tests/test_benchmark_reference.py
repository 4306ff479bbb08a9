"""The plain reference against the port's plain CPU path at tiny widths
(the test side alone imports both): the inputs, the inits, the forwards
and their gradients, the Fourier Radon operator and Adam."""
import numpy as np
import pytest
import torch

from wire_tpu_torch import tree
from wire_tpu_torch.apps import ct, denoise, sweep
from wire_tpu_torch.nn.registry import get_inr
from wire_tpu_torch.operators import radon as R
from wire_tpu_torch.ops import wire_mlp as WM
from wire_tpu_torch.signals import coords as C
from wire_tpu_torch.train import trainer
from wire_tpu_torch.train.presets import get_config

from benchmark import lookup
from benchmark.reference import adam, bspline_form, matmul, radon_fourier
from benchmark.reference import signals as RS
from benchmark.reference import wire

SEED = 1234567


def test_inputs_are_the_apps_bit_for_bit():
    traffic = lookup.traffic("denoise_wire_s8_o7")
    im, noisy = RS.denoise_images(SEED, traffic)
    im_p, noisy_p = denoise.denoise_images(
        get_config("WIRE_s8_o7_LR5e3_E2000"), None, SEED)
    assert im.dtype == noisy.dtype == np.float32
    assert np.array_equal(im, im_p) and np.array_equal(noisy, noisy_p)
    im_s, noisy_s = sweep.denoise_images(None, SEED)
    assert np.array_equal(im, im_s) and np.array_equal(noisy, noisy_s)
    field = RS.ct_image(SEED, lookup.traffic("ct_wire_s12_o8"))
    assert np.array_equal(field, ct.ct_image(None, SEED))
    assert np.array_equal(RS.grid2d(12, 7), C.grid2d(12, 7))


def _port(family, hidden, out, traffic):
    kw = dict(in_features=2, out_features=out, hidden_features=hidden,
              hidden_layers=2, scale=traffic["scale"], fused="never")
    if family == "wire":
        kw.update(first_omega0=traffic["omega0"],
                  hidden_omega0=traffic["omega0"])
    return get_inr(family, **kw)


@pytest.mark.parametrize("family, mod, traffic", [
    ("wire", wire, "denoise_wire_s8_o7"), ("wire", wire, "ct_wire_s12_o8"),
    ("bspline_form", bspline_form, "denoise_bspline_s9_5")])
def test_family_init_forward_and_gradient(family, mod, traffic):
    traffic = lookup.traffic(traffic)
    out = traffic["channels"]
    config = {"in_features": 2, "hidden_features": 16, "hidden_layers": 2}
    model = _port(family, 16, out, traffic)
    port = dict(tree.leaves(model.init(torch.Generator().manual_seed(SEED))))
    ref = adam.flat(mod.init(torch.Generator().manual_seed(SEED), config,
                             out))
    assert sorted(ref) == sorted("/".join(map(str, k)) for k in port)
    for k, v in port.items():
        assert torch.equal(ref["/".join(map(str, k))], v)
    x = torch.from_numpy(C.grid2d(9, 11)) * 0.9
    want = model.apply(tree.unflatten(list(port), list(port.values())), x)
    leaves = {k: v.clone().requires_grad_(True) for k, v in ref.items()}
    got = mod.apply(adam.nest(leaves), x, config, traffic, matmul.fp32)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    # the gradient of the same loss through the port's own step
    target = torch.linspace(-1, 1, got.numel()).reshape(got.shape)
    loss = torch.sum((got - target) ** 2) / got.numel()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()), allow_unused=True)))
    _, pgrads = model.step_grads(tree.unflatten(list(port),
                                                list(port.values())),
                                 x, target)
    for k, g in tree.leaves(pgrads):
        mine = grads["/".join(map(str, k))]
        mine = torch.zeros_like(g) if mine is None else mine
        assert torch.allclose(mine, g, rtol=1e-4,
                              atol=1e-6 * float(g.abs().max() + 1))


def test_fourier_radon_and_its_adjoint():
    img = torch.from_numpy(RS.ct_image(SEED, {"image_size": 80}))
    thetas = np.linspace(0, 180, 9, dtype=np.float32)
    a = img.clone().requires_grad_(True)
    b = img.clone().requires_grad_(True)
    got = radon_fourier.radon(a, thetas)
    want = R._radon_fourier(b, thetas, sampler="plain")
    assert got.shape == want.shape == (9, 40)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    w = torch.linspace(0, 1, got.numel()).reshape(got.shape)
    (ga,) = torch.autograd.grad((got * w).sum(), [a])
    (gb,) = torch.autograd.grad((want * w).sum(), [b])
    assert torch.allclose(ga, gb, rtol=1e-5, atol=1e-5)


def test_adam_first_steps_are_the_trainers():
    gen = torch.Generator().manual_seed(3)
    params = {"a": {"w": torch.randn(4, 3, generator=gen)},
              "b": {"w": torch.randn(5, generator=gen)}}
    target = torch.randn(3, generator=gen)

    def loss_of(p):
        return ((p["a"]["w"].sum(0) - target) ** 2).sum() + \
            (p["b"]["w"] ** 3).sum()

    traffic = {"learning_rate": 5e-3, "lr_decay": 0.1, "epochs": 7,
               "maxpoints": 100, "scale_lr_by_batch": True}
    losses, g0, p3 = adam.first_steps(
        adam.flat(params), lambda leaves: loss_of(adam.nest(leaves)), traffic,
        rows=400)
    cfg = trainer.FitConfig(learning_rate=5e-3, niters=7, maxpoints=100,
                            scale_lr_by_batch=True)
    p = {k: {"w": v["w"].clone()} for k, v in params.items()}
    opt = trainer.Adam(cfg, p, npoints=400)
    for t in range(3):
        leaves = {k: v["w"].clone().requires_grad_(True)
                  for k, v in p.items()}
        loss = loss_of({k: {"w": v} for k, v in leaves.items()})
        assert float(loss.detach()) == pytest.approx(losses[t], rel=1e-6)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        if t == 0:
            for (k, _), g in zip(leaves.items(), grads):
                assert torch.allclose(g0[f"{k}/w"], g)
        opt.step(p, {k: {"w": g} for k, g in zip(leaves, grads)})
    for k in p:
        assert torch.allclose(p3[f"{k}/w"], p[k]["w"], rtol=1e-6, atol=1e-7)


def test_tf32_products_round_as_the_port_models_them():
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(64, 48, generator=gen)
    b = torch.randn(48, 32, generator=gen)
    assert torch.equal(matmul.tf32_round(a), WM.tf32_round(a))
    got = matmul.tf32(a, b)
    want = WM.tf32_round(a) @ WM.tf32_round(b)
    assert torch.equal(got, want)
    rel = float((got - a @ b).abs().max() / (a @ b).abs().max())
    assert 1e-5 < rel < 1e-2
    a.requires_grad_(True)
    (ga,) = torch.autograd.grad(matmul.tf32(a, b).sum(), [a])
    assert torch.equal(ga, matmul.tf32_round(torch.ones(64, 32))
                       @ matmul.tf32_round(b).T)
