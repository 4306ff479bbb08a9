"""The port's image files (wire_tpu_torch/signals/png.py, signals/
image.py's imread/imsave, signals/colormaps.py, train/artifacts.py's
display_image, the apps' PNG ``--image``) against wire_tpu's, which read
and write them through matplotlib and Pillow.

Reading: the port's ``imread`` equals wire_tpu's (``plt.imread``, then
the alpha drop and the min-max normalization) bit for bit on the PNGs
Pillow writes at each colour type and depth it can write, and ``to_float``
equals ``plt.imread`` bit for bit on PNGs of every colour type, bit depth,
interlace method and scanline filter that this file's own encoder writes
(Pillow writes no 2- or 4-bit grey, no 16-bit colour and no Adam7).
Writing: ``display_image``'s Output_img.png decoded by ``plt.imread``
equals wire_tpu's for the same info.mat, RGB and gray; ``imsave`` equals
``plt.imsave`` pixel for pixel at the colour maps, limits, NaN and dtypes
the port's callers use.  Every comparison is exact: both sides quantize
the same float32 values to the same 8-bit samples.
"""
import io as pyio
import os
import struct
import zlib

import numpy as np
import pytest
from scipy import io

from wire_tpu.signals import image as JI
from wire_tpu.train import artifacts as JA

from wire_tpu_torch.apps import common as TC
from wire_tpu_torch.signals import colormaps
from wire_tpu_torch.signals import image as TI
from wire_tpu_torch.signals import png as P
from wire_tpu_torch.train import artifacts as TA

plt = pytest.importorskip("matplotlib.pyplot")
Image = pytest.importorskip("PIL.Image")


def _encode(samples, depth, ctype, palette=None, trns=None, interlace=0):
    """A PNG of (h, w, channels) samples at any depth and colour type, its
    scanlines filtered with types 0-4 in turn, Adam7 when ``interlace``."""
    ch = samples.shape[2]
    bpp = max(1, ch * depth // 8)

    def rows_of(s):
        hh = s.shape[0]
        if depth == 16:
            return s.astype(">u2").reshape(hh, -1).view(np.uint8)
        if depth == 8:
            return s.astype(np.uint8).reshape(hh, -1)
        v = s.reshape(hh, -1).astype(np.uint8)
        bits = (v[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        return np.packbits(bits.reshape(hh, -1), axis=1)

    def filtered(b):
        out, prior = [], np.zeros(b.shape[1], np.int64)
        for r in range(b.shape[0]):
            x = b[r].astype(np.int64)
            ft = r % 5
            a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])[:len(x)]
            c = np.concatenate([np.zeros(bpp, np.int64),
                                prior[:-bpp]])[:len(x)]
            if ft == 0:
                y = x
            elif ft == 1:
                y = x - a
            elif ft == 2:
                y = x - prior
            elif ft == 3:
                y = x - (a + prior) // 2
            else:
                p = a + prior - c
                pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c)
                y = x - np.where((pa <= pb) & (pa <= pc), a,
                                 np.where(pb <= pc, prior, c))
            out.append(bytes([ft]) + (y & 255).astype(np.uint8).tobytes())
            prior = x
        return b"".join(out)

    if interlace:
        raw = b"".join(filtered(rows_of(samples[y0::dy, x0::dx]))
                       for x0, y0, dx, dy in P._ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = filtered(rows_of(samples))
    h, w = samples.shape[:2]
    out = P.SIGNATURE + P._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += P._chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += P._chunk(b"tRNS", trns)
    return out + P._chunk(b"IDAT", zlib.compress(raw)) + P._chunk(b"IEND",
                                                                  b"")


CRAFTED = [(ct, d, il) for ct, ds in sorted(P._DEPTHS.items()) for d in ds
           for il in (0, 1)]


@pytest.mark.parametrize("ctype,depth,interlace", CRAFTED)
def test_decode_equals_plt_imread(ctype, depth, interlace):
    rng = np.random.RandomState(ctype * 100 + depth * 2 + interlace)
    ch = P._CHANNELS[ctype]
    hi = min(7, 1 << depth) if ctype == 3 else 1 << depth
    s = rng.randint(0, hi, (13, 11, ch))
    pal = rng.randint(0, 256, (7, 3)) if ctype == 3 else None
    trns = bytes([10, 200, 255]) if ctype == 3 else None
    data = _encode(s, depth, ctype, pal, trns, interlace)
    png = P.decode(data)
    np.testing.assert_array_equal(png["samples"], s)
    got, want = P.to_float(png), plt.imread(pyio.BytesIO(data))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _pillow(mode, path, rng):
    H, W = 9, 14
    kw = {}
    if mode == "1":
        im = Image.fromarray(rng.rand(H, W) > 0.5)
    elif mode == "I;16":
        im = Image.fromarray(rng.randint(0, 65536, (H, W)).astype(np.uint16))
    elif mode.startswith("P"):
        ncolors = int(mode[1:].split("t")[0])
        im = Image.fromarray(rng.randint(0, ncolors, (H, W)).astype(
            np.uint8), mode="P")
        im.putpalette(rng.randint(0, 256, 3 * ncolors).astype(
            np.uint8).tobytes())
        if mode.endswith("t"):
            kw["transparency"] = bytes(rng.randint(0, 256, ncolors).astype(
                np.uint8))
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        a = rng.randint(0, 256, (H, W, ch)).astype(np.uint8)
        im = Image.fromarray(a[..., 0] if ch == 1 else a, mode=mode)
    im.save(path, **kw)
    return path


PILLOW_MODES = ["1", "L", "I;16", "LA", "RGB", "RGBA", "P2", "P4", "P16",
                "P256", "P16t"]


@pytest.mark.parametrize("mode", PILLOW_MODES)
def test_imread_matches_wire_tpu_on_pillow_files(mode, tmp_path):
    path = _pillow(mode, str(tmp_path / "x.png"),
                   np.random.RandomState(len(mode)))
    for full in (True, False):
        got = TI.imread(path, normalize_full=full)
        want = JI.imread(path, normalize_full=full)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_malformed_files_raise(tmp_path):
    good = _encode(np.zeros((2, 2, 3), np.uint8), 8, 2)
    bad_crc = bytearray(good)
    bad_crc[30] ^= 1
    ihdr_end = 8 + 12 + 13
    idat = zlib.compress(b"\x07" + bytes(6) + b"\x00" + bytes(6))
    bad_filter = (good[:ihdr_end] + P._chunk(b"IDAT", idat)
                  + P._chunk(b"IEND", b""))
    bad_depth = P.SIGNATURE + P._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 2, 2, 4, 2, 0, 0, 0)) + P._chunk(b"IEND", b"")
    for data, match in ((b"GIF89a" + good[6:], "signature"),
                        (bytes(bad_crc), "CRC"),
                        (bad_filter, "filter type 7"),
                        (bad_depth, "bit depth 4"),
                        (good[:-12], "IEND")):
        with pytest.raises(ValueError, match=match):
            P.decode(data)
    jpg = str(tmp_path / "x.jpg")
    with open(jpg, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0")
    with pytest.raises(ValueError, match="not a PNG"):
        TI.imread(jpg)


def test_colormap_tables_are_matplotlibs():
    import matplotlib
    for name in ("gray", "viridis"):
        cm = matplotlib.colormaps[name]
        cm._init()
        want = (cm._lut * 255).astype(np.uint8)[:256, :3]
        np.testing.assert_array_equal(colormaps.table(name), want)
    with pytest.raises(ValueError, match="jet"):
        colormaps.table("jet")


def _imsave_cases():
    rng = np.random.RandomState(1)
    g = rng.rand(17, 13).astype(np.float32)
    g[0, 0], g[1, 1] = 0.0, 1.0
    nan = g.copy()
    nan[2, 2] = np.nan
    return [(g, dict(vmin=0.0, vmax=1.0, cmap="gray")),
            (g * 0.7 + 0.1, dict(cmap="gray")),
            (g * 0.3, dict(vmin=0.0, vmax=0.1)),
            (g.astype(np.float64), dict(cmap="viridis")),
            (nan, dict(vmin=0.0, vmax=1.0, cmap="gray")),
            (rng.rand(9, 7, 3).astype(np.float32), dict(vmin=0.0, vmax=1.0)),
            (rng.rand(9, 7, 3), {})]


@pytest.mark.parametrize("case", range(7))
def test_imsave_equals_plt_imsave(case, tmp_path):
    arr, kw = _imsave_cases()[case]
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    plt.imsave(a, arr, **kw)
    TI.imsave(b, arr, **kw)
    np.testing.assert_array_equal(plt.imread(b), plt.imread(a))
    assert P.decode(open(b, "rb").read())["color_type"] == 6


@pytest.mark.parametrize("rgb", [True, False], ids=["rgb", "gray"])
def test_display_image_matches_wire_tpu(rgb, tmp_path):
    rng = np.random.RandomState(3)
    shape = (20, 18, 3) if rgb else (20, 18)
    rec = (rng.randn(*shape) * 0.6 + 0.4).astype(np.float32)
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
        io.savemat(str(tmp_path / side / "info.mat"),
                   {"run_1": {"rec": rec, "gt": rec}})
    TA.display_image(str(tmp_path / "port" / "info.mat"))
    JA.display_image(str(tmp_path / "jax" / "info.mat"))
    got = plt.imread(str(tmp_path / "port" / "Output_img.png"))
    want = plt.imread(str(tmp_path / "jax" / "Output_img.png"))
    np.testing.assert_array_equal(got, want)
    back = TI.imread(str(tmp_path / "port" / "Output_img.png"), False)
    q = np.clip(np.abs(rec), 0, 1)
    if rgb:
        # the port reads back the rec quantized to 8 bits
        q = (q * 255).astype(np.uint8) / np.float32(255)
    else:
        # a 2-D rec through the gray table, which is not the identity
        q = colormaps.table("gray")[np.minimum(
            (q * 256).astype(int), 255)] / np.float32(255)
    np.testing.assert_array_equal(back, q)


def test_write_run_artifacts_writes_output_img(tmp_path):
    rec = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    with_rec = TC.write_run_artifacts(str(tmp_path), "t", "run",
                                      {"rec": rec}, {"PSNR": 1.0})
    without = TC.write_run_artifacts(str(tmp_path), "t", "run",
                                     {"gt": rec}, {"PSNR": 1.0})
    assert sorted(os.listdir(with_rec)) == ["Output_img.png", "info.mat",
                                            "metrics.mat", "metrics_table.md"]
    assert "Output_img.png" not in os.listdir(without)


@pytest.mark.parametrize("channels", [3, 1])
def test_load_image_reads_png_as_wire_tpu(channels, tmp_path):
    from wire_tpu.apps import common as JC
    png = str(tmp_path / "in.png")
    TI.imsave(png, JI.synthetic_image(24, 20, 3, seed=2))
    got = TC.load_image(png, channels=channels)
    want = JC.load_image(png, channels=channels)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    npy = str(tmp_path / "in.npy")
    np.save(npy, want)
    np.testing.assert_array_equal(TC.load_image(npy, channels=channels),
                                  want)


def test_multi_sr_reads_png(tmp_path):
    from wire_tpu_torch.apps import multi_sr
    png = str(tmp_path / "in.png")
    TI.imsave(png, JI.synthetic_image(32, 32, 3, seed=4))
    prob = multi_sr.setup(image=png, scale_sr=2, niters=1,
                          hidden_features=8, hidden_layers=1)
    np.testing.assert_array_equal(prob["im"], JI.imread(png))
