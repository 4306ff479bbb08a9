"""mscale2_step on the tensor cores (csrc/real_tc.cuh), on the CPU: the
plain model of its epilogue's row and column map with a gamma per row
(ops/mscale2_step.py:epilogue_map), and the float64 reference the kernel is
held to on the card (chip_smoke.py:compare_float64): every input cast to
float64, every output float64, and the same function as the fp32 plain
step where no combiner relu unit lies near its kink."""
import numpy as np
import pytest
import torch

import chip_smoke
from wire_tpu_torch.ops import mscale2_step as MS
from wire_tpu_torch.ops import real_mlp as RM

INV = (9.0, 0.25, 0.125)
WIDTH = 256  # the path's hidden width


@pytest.mark.parametrize("ns", [2, 3])
@pytest.mark.parametrize("n", [700, 65537])
def test_epilogue_map_gives_each_row_its_scales_gamma(n, ns):
    """Under the plain column map at the path's width, every row of a
    128-row tile that straddles two scales gets its own scale's gamma, and
    the tiles' registers put the stacked layout back exactly: each output
    of the tiles' rows once, at its own row and column.  At n = 700 every
    tile of the layer; at 65,537 the straddling tiles and the last, ragged
    one."""
    rows = ns * n
    row_tiles = -(-rows // MS.TILE_ROWS)
    straddling = sorted({s * n // MS.TILE_ROWS for s in range(1, ns)
                         if (s * n) % MS.TILE_ROWS})
    assert len(straddling) == ns - 1
    tiles = (range(row_tiles) if n == 700
             else straddling + [row_tiles - 1])
    scale_of_row = np.repeat(np.arange(ns), n)
    gammas = torch.tensor(INV[:ns], dtype=torch.float64)
    rng = np.random.default_rng(n + ns)
    for by in tiles:
        r0 = by * MS.TILE_ROWS
        r1 = min(rows, r0 + MS.TILE_ROWS)
        # the layer's outputs in the tile's rows, and gamma times them
        block = torch.tensor(rng.normal(size=(r1 - r0, WIDTH)))
        want = gammas[torch.from_numpy(scale_of_row[r0:r1])][:, None] * block
        out = torch.full_like(block, float("nan"))
        count = torch.zeros(block.shape, dtype=torch.int64)
        scales = set()
        for bx in range(-(-WIDTH // MS.TILE_COLS)):
            r, c, b = MS.epilogue_map(r0, bx * MS.TILE_COLS, n)
            live = (r < rows) & (c < WIDTH)
            r, c, b = r[live] - r0, c[live], b[live]
            assert ((r >= 0) & (r < r1 - r0)).all()
            assert np.array_equal(b.numpy(), scale_of_row[r.numpy() + r0])
            scales.update(b.unique().tolist())
            out[r, c] = gammas[b] * block[r, c]
            count.index_put_((r, c), torch.ones_like(r), accumulate=True)
        assert (count == 1).all()
        assert torch.equal(out, want)
        if by in straddling:
            assert len(scales) == 2, (by, scales)


def _problem(n, ns, widths, seed):
    """A seeded trunk, freq_combine combiner and inputs, float32."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))
    canon = {"layers": [{"w": t(rng.uniform(-1, 1, (a, b)) / np.sqrt(a)),
                         "alpha": t(rng.uniform(0.5, 2.0, b)),
                         "beta": t(rng.uniform(-1, 1, b))}
                        for a, b in zip(widths[:-2], widths[1:-1])],
             "final": {"w": t(rng.uniform(-1, 1, widths[-2:])),
                       "b": t(rng.uniform(-1, 1, widths[-1]))}}
    o = widths[-1]
    comb = {"freq_0": {"w": t(rng.uniform(-0.5, 0.5, (ns * o, 128))),
                       "b": t(rng.uniform(-0.5, 0.5, 128))},
            "freq_1": {"w": t(rng.uniform(-0.3, 0.3, (128, o))),
                       "b": t(rng.uniform(-0.5, 0.5, o))}}
    c, tg, gt = (t(a) for a in (rng.uniform(-1, 1, (n, 2)),
                                rng.uniform(0, 1, (n, o)),
                                rng.uniform(0, 1, (n, o))))
    return canon, comb, c, tg, gt


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in x for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _leaves(item)]
    return [x]


def test_float64_helper_casts_every_leaf(monkeypatch):
    """compare_float64 gives mscale2_step_plain every input in float64: the
    trunk, the combiner, the coordinates, target and gt, and the inverse
    scales (given here as numpy float32 values, one of them 1/3); the rows'
    gammas are built in float64, and every output comes back float64."""
    canon, comb, c, t, gt = _problem(150, 3, (2, 24, 16, 3), 5)
    kinds = RM.norm_kinds(("qspline", "cspline"))
    inv = tuple(np.float32(g) for g in (9.0, 0.25, 1 / 3))
    seen, gammas = {}, []
    plain_step, row_gammas = MS.mscale2_step_plain, RM._row_gammas

    def spy(*args, **kwargs):
        seen["args"], seen["kwargs"] = args, kwargs
        return chip_smoke.mscale2_tensors(*plain_step(*args, **kwargs))

    def spy_gammas(*args, **kwargs):
        gammas.append(row_gammas(*args, **kwargs))
        return gammas[-1]
    monkeypatch.setattr(RM, "_row_gammas", spy_gammas)
    kw = dict(nvalid=140, denom=433.5, gt=gt, want_metrics=True)
    got = chip_smoke.mscale2_tensors(*plain_step(canon, comb, c, t, kinds,
                                                 inv, **kw))
    assert all(g.dtype == torch.float32 for g in gammas)
    _, want = chip_smoke.compare_float64(
        got, spy, (canon, comb, c, t, kinds, inv), kw, "mscale2 plain")
    a_canon, a_comb, a_c, a_t, a_kinds, a_inv = seen["args"]
    for x in _leaves([a_canon, a_comb, a_c, a_t, seen["kwargs"]["gt"]]):
        assert x.dtype == torch.float64
    assert a_kinds == kinds
    assert all(type(g) is float for g in a_inv)
    assert a_inv == tuple(float(g) for g in inv)
    assert seen["kwargs"]["nvalid"] == 140
    assert gammas[-1].dtype == torch.float64
    assert float(gammas[-1][-1]) == float(np.float32(1 / 3))
    assert want.keys() == got.keys()
    for name, w in want.items():
        assert w.dtype == torch.float64, name


def test_float64_and_fp32_plain_steps_agree_away_from_the_relu_kink():
    """At a small case whose combiner relu inputs all lie more than 1e-5 x
    max |u| from 0 (so fp32 rounding cannot flip one), the fp32 plain step
    and the plain step run in float64 agree within 1e-5 x max on every
    output: the float64 reference is the same function, not another one."""
    n, ns, widths = 100, 3, (2, 32, 32, 3)
    canon, comb, c, t, gt = _problem(n, ns, widths, 7)
    kinds = RM.norm_kinds(("qspline",) * 2)
    inv = INV[:ns]
    c64 = chip_smoke.float64_tree((canon, comb, c))
    with torch.no_grad():
        ys = RM.real_mlp_plain(c64[0], c64[2].repeat(ns, 1), kinds, (inv, n))
        cat = ys.reshape(ns, n, 3).permute(1, 0, 2).reshape(n, ns * 3)
        u = cat @ c64[1]["freq_0"]["w"] + c64[1]["freq_0"]["b"]
    assert float(u.abs().min()) > 1e-5 * float(u.abs().max())
    kw = dict(nvalid=95, gt=gt, want_metrics=True)

    def plain(*args, **kwargs):
        return chip_smoke.mscale2_tensors(*MS.mscale2_step_plain(*args,
                                                                 **kwargs))
    got = plain(canon, comb, c, t, kinds, inv, **kw)
    _, want = chip_smoke.compare_float64(got, plain,
                                         (canon, comb, c, t, kinds, inv), kw,
                                         "fp32 plain")
    for name, w in want.items():
        err = float((got[name].double() - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)
