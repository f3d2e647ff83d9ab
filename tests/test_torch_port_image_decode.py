"""The port's JPEG/PNG decoder (multi_modal_tracking_torch/csrc/host/image.cpp,
bound in multi_modal_tracking_torch/native) against the JAX package's
readers, bit for bit: its libjpeg decoder (`native.decode_jpeg`, the
system's libjpeg-turbo) and cv2.imread (cv2's own libjpeg-turbo and
libpng), on images written here with cv2 or with zlib:

  * JPEG over every sampling factor cv2 writes (4:4:4, 4:2:2, 4:2:0,
    4:4:0, 4:1:1) and greyscale, baseline, progressive and with restart
    intervals, optimised Huffman tables or not, qualities 50 to 100 and
    sizes 1x1 to 641x479; SOF1 and a 3-component RGB file made by patching
    a baseline file;
  * PNG colour types 0, 2, 3, 4 and 6 at 8 bits and type 0 at 16 bits, with
    every scanline filter, read as colour and (grey) unchanged;
  * one case per format the decoder raises for, with the file's path and
    the reason in the message;
  * the committed fixtures of tests/torch_port_images/ against the
    SHA-256 digests of manifest.json, which both readers reproduce.

`python tests/test_torch_port_image_decode.py --write` remakes the
fixtures and the manifest from the port's seeded synthetic frames.
"""
import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from multi_modal_tracking_tpu import native as jax_native
from multi_modal_tracking_torch import native
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_images")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(1, 1), (2, 3), (13, 17), (17, 13), (48, 64), (479, 641)]


def _image(rng, h, w, grey=False):
    """Smooth structure plus noise, so that every coefficient band is used."""
    y, x = np.mgrid[0:h, 0:w]
    phase = rng.uniform(0, 6, 3)
    base = np.stack([np.sin(x / (3 + 4 * k) + phase[k]) * 70 + np.cos(y / (5 + 3 * k)) * 50 + 128
                     for k in range(3)], -1)
    img = np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def _jpeg(path, img, quality=90, sampling="420", progressive=False, restart=0, optimize=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              SAMPLING[sampling], cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
    assert cv2.imwrite(str(path), img, params)
    return str(path)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _readers_agree(path):
    """The port's decode of a JPEG equals libjpeg's and cv2's; returns it."""
    got = native.decode_jpeg(path)
    want = jax_native.decode_jpeg(str(path))
    assert want is not None
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), f"{path}: {np.count_nonzero(got != want)} samples differ"
    assert np.array_equal(got, _cv2_rgb(path))
    return got


# --------------------------------------------------------------------- JPEG
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411", "grey"])
@pytest.mark.parametrize("mode", ["baseline", "progressive", "restart", "progressive_restart"])
def test_jpeg_equals_libjpeg_and_cv2(tmp_path, sampling, mode):
    rng = np.random.default_rng(zlib.crc32(f"{sampling}-{mode}".encode()))
    for k, (h, w) in enumerate(SIZES):
        img = _image(rng, h, w, grey=sampling == "grey")
        path = _jpeg(tmp_path / f"{k}.jpg", img, quality=int(rng.integers(50, 101)),
                     sampling="420" if sampling == "grey" else sampling,
                     progressive="progressive" in mode,
                     restart=int(rng.integers(1, 4)) if "restart" in mode else 0,
                     optimize=bool(k % 2))
        got = _readers_agree(path)
        assert got.shape == (h, w, 3)
        if sampling == "grey":
            assert np.array_equal(got[..., 0], got[..., 2])


def _segments(data):
    """(marker, start, end) of each marker segment before the first SOS."""
    pos, out = 2, []
    while True:
        m = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((m, pos, pos + 2 + length))
        if m == 0xDA:
            return out
        pos += 2 + length


def _patched(data, marker, offset, value):
    """data with byte `offset` of the first `marker` segment's body set."""
    for m, start, _ in _segments(data):
        if m == marker:
            b = bytearray(data)
            b[start + 4 + offset] = value
            return bytes(b)
    raise AssertionError(f"no marker {marker:#x}")


def test_sof1_and_rgb_files_equal_libjpeg(tmp_path):
    """An extended sequential (SOF1) file decodes as its baseline twin; a
    3-component file without JFIF whose ids are 'R', 'G', 'B' is RGB, copied
    through the upsampler, as libjpeg reads it."""
    rng = np.random.default_rng(1)
    base = open(_jpeg(tmp_path / "b.jpg", _image(rng, 40, 56), sampling="444"), "rb").read()
    sof1 = tmp_path / "sof1.jpg"
    sof1.write_bytes(base.replace(b"\xff\xc0", b"\xff\xc1", 1))
    assert np.array_equal(_readers_agree(sof1), native.decode_jpeg(base))
    segs = _segments(base)
    app0 = [(s, e) for m, s, e in segs if m == 0xE0][0]
    rgb = bytearray(base[:app0[0]] + base[app0[1]:])
    for m, start, _ in _segments(bytes(rgb)):         # the frame's ids and the scan's
        for k, cid in enumerate(b"RGB"):
            if m == 0xC0:
                rgb[start + 4 + 6 + 3 * k] = cid
            elif m == 0xDA:
                rgb[start + 4 + 1 + 2 * k] = cid
    path = tmp_path / "rgb.jpg"
    path.write_bytes(bytes(rgb))
    got = _readers_agree(path)
    assert not np.array_equal(got, native.decode_jpeg(base))


def test_bytes_and_batch_equal_single_decodes(tmp_path):
    rng = np.random.default_rng(2)
    paths = [_jpeg(tmp_path / f"{k}.jpg", _image(rng, 30 + 7 * k, 40 + 5 * k),
                   sampling=("420", "444", "422")[k % 3]) for k in range(5)]
    singles = [native.decode_jpeg(p) for p in paths]
    for p, s in zip(paths, singles):
        assert np.array_equal(native.decode_jpeg(open(p, "rb").read()), s)
        assert np.array_equal(native.imread(p), s)
    buf, hs, ws = native.decode_jpeg_batch(paths, 64, 64, num_threads=3)
    want = jax_native.decode_jpeg_batch(paths, 64, 64, num_threads=3)
    for k, s in enumerate(singles):
        assert (hs[k], ws[k]) == s.shape[:2]
        assert np.array_equal(buf[k, :hs[k], :ws[k]], s) and not buf[k, hs[k]:].any()
        assert np.array_equal(buf[k], want[0][k])
    with pytest.raises(ValueError, match="does not fit"):
        native.decode_jpeg_batch(paths, 32, 64)
    bad = str(tmp_path / "missing.jpg")
    with pytest.raises(ValueError, match="missing.jpg"):
        native.decode_jpeg_batch(paths[:2] + [bad], 64, 64)


def test_incomplete_progressive_raises_where_libjpeg_smooths(tmp_path):
    """A complete progressive file is decoded without block smoothing, and
    libjpeg's equals it (the grid above): its smoothing changes nothing
    there. Cut after the first AC scans, the file leaves coefficients
    unknown; libjpeg smooths its blocks (its decode differs from the
    complete one's), and the port raises."""
    rng = np.random.default_rng(3)
    data = open(_jpeg(tmp_path / "p.jpg", _image(rng, 64, 80), progressive=True), "rb").read()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    assert len(sos) > 6
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:sos[4]] + b"\xff\xd9")
    smoothed = jax_native.decode_jpeg(str(cut))
    assert smoothed is not None and not np.array_equal(smoothed, native.decode_jpeg(data))
    with pytest.raises(ValueError, match=r"cut\.jpg.*smooth"):
        native.decode_jpeg(cut)


def _raises(tmp_path, name, data, match, reader=native.imread):
    path = tmp_path / name
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as e:
        reader(path)
    assert str(path) in str(e.value)


@pytest.fixture(scope="module")
def baseline_bytes(tmp_path_factory):
    path = tmp_path_factory.mktemp("base") / "b.jpg"
    return open(_jpeg(path, _image(np.random.default_rng(4), 24, 32)), "rb").read()


@pytest.mark.parametrize("case", ["arithmetic", "lossless", "hierarchical", "12bit", "cmyk",
                                  "two_components", "dnl_height", "fractional", "truncated",
                                  "corrupt", "not_an_image"])
def test_jpeg_formats_not_decoded_raise(tmp_path, baseline_bytes, case):
    b = baseline_bytes
    if case == "arithmetic":
        _raises(tmp_path, "a.jpg", b.replace(b"\xff\xc0", b"\xff\xc9", 1), "SOF9.*arithmetic")
    elif case == "lossless":
        _raises(tmp_path, "l.jpg", b.replace(b"\xff\xc0", b"\xff\xc3", 1), "SOF3.*lossless")
    elif case == "hierarchical":
        _raises(tmp_path, "h.jpg", b.replace(b"\xff\xc0", b"\xff\xc5", 1), "SOF5.*hierarch")
    elif case == "12bit":
        _raises(tmp_path, "p.jpg", _patched(b, 0xC0, 0, 12), "12-bit")
    elif case == "cmyk":
        _raises(tmp_path, "c.jpg", _patched(b, 0xC0, 5, 4), "CMYK")
    elif case == "two_components":
        _raises(tmp_path, "2.jpg", _patched(b, 0xC0, 5, 2), "2 components")
    elif case == "dnl_height":
        _raises(tmp_path, "d.jpg", _patched(_patched(b, 0xC0, 1, 0), 0xC0, 2, 0), "DNL")
    elif case == "fractional":
        _raises(tmp_path, "f.jpg", _patched(_patched(b, 0xC0, 7, 0x32), 0xC0, 10, 0x21),
                "fractional")
    elif case == "truncated":
        _raises(tmp_path, "t.jpg", b[:len(b) * 2 // 3], "ends early|truncated")
    elif case == "corrupt":
        _raises(tmp_path, "x.jpg", b[:-40] + b"\xff\xd0" + b[-38:], "corrupt")
    else:
        _raises(tmp_path, "n.jpg", b"GIF89a" + b[6:], "not a JPEG or PNG")
        with pytest.raises(ValueError, match="no SOI"):
            native.decode_jpeg(b"GIF89a")


# ---------------------------------------------------------------------- PNG
def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path, arr, color_type, depth=8, palette=None, filters=(0, 1, 2, 3, 4),
              interlace=0):
    """A PNG of `arr` (H, W[, C], in the colour type's channel order) with
    the scanline filters taken in turn row by row; zlib and numpy only."""
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1).astype(">u2" if depth == 16 else np.uint8)
    raw = rows.view(np.uint8).reshape(h, -1).astype(np.int64)
    bpp = max(1, raw.shape[1] // w)
    out, prev = [], np.zeros_like(raw[0])
    for y in range(h):
        f, r = filters[y % len(filters)], raw[y]
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2, 4: _paeth(left, prev, upleft)}[f]
        out.append(bytes([f]) + ((r - pred) % 256).astype(np.uint8).tobytes())
        prev = r
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                                   color_type, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    data += _chunk(b"IDAT", zlib.compress(b"".join(out))) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("color_type,depth", [(0, 8), (0, 16), (2, 8), (3, 8), (4, 8), (6, 8)])
def test_png_equals_cv2(tmp_path, color_type, depth):
    rng = np.random.default_rng(10 * color_type + depth)
    for k, (h, w) in enumerate(SIZES[:5]):
        c = CHANNELS[color_type]
        hi = 2 ** depth if color_type != 3 else 11
        arr = rng.integers(0, hi, (h, w, c) if c > 1 else (h, w)).astype(
            np.uint16 if depth == 16 else np.uint8)
        pal = rng.integers(0, 256, (11, 3)) if color_type == 3 else None
        path = write_png(tmp_path / f"{k}.png", arr, color_type, depth, pal)
        got = native.decode_png(path)
        assert got.shape == (h, w, 3) and np.array_equal(got, _cv2_rgb(path))
        assert np.array_equal(native.imread(path), got)
        if color_type == 0:
            raw = native.imread_unchanged(path)
            want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            assert raw.dtype == want.dtype == arr.dtype and np.array_equal(raw, want)
            assert np.array_equal(raw, arr)


@pytest.mark.parametrize("case", ["interlaced", "rgb16", "grey1", "bad_crc", "palette_index",
                                  "unchanged_colour", "truncated"])
def test_png_formats_not_decoded_raise(tmp_path, case):
    rng = np.random.default_rng(5)
    grey = rng.integers(0, 256, (6, 5), np.uint8)
    if case == "interlaced":
        write_png(tmp_path / "i.png", grey, 0, interlace=1)
        _raises(tmp_path, "i.png", open(tmp_path / "i.png", "rb").read(), "Adam7")
    elif case == "rgb16":
        write_png(tmp_path / "r.png", rng.integers(0, 65535, (4, 4, 3)), 2, depth=16)
        _raises(tmp_path, "r.png", open(tmp_path / "r.png", "rb").read(), "16 bits")
    elif case == "grey1":
        data = open(write_png(tmp_path / "g.png", grey, 0), "rb").read()
        ihdr = struct.pack(">IIBBBBB", 5, 6, 1, 0, 0, 0, 0)
        _raises(tmp_path, "g1.png", data[:8] + _chunk(b"IHDR", ihdr) + data[33:], "1 bits")
    elif case == "bad_crc":
        data = bytearray(open(write_png(tmp_path / "c.png", grey, 0), "rb").read())
        data[40] ^= 0xFF
        _raises(tmp_path, "c2.png", bytes(data), "CRC")
    elif case == "palette_index":
        write_png(tmp_path / "p.png", np.full((3, 3), 9, np.uint8), 3, palette=[[1, 2, 3]] * 4)
        _raises(tmp_path, "p.png", open(tmp_path / "p.png", "rb").read(), "palette index")
    elif case == "unchanged_colour":
        write_png(tmp_path / "u.png", rng.integers(0, 256, (4, 4, 3)), 2)
        _raises(tmp_path, "u.png", open(tmp_path / "u.png", "rb").read(), "grey images only",
                reader=native.imread_unchanged)
    else:
        data = open(write_png(tmp_path / "t.png", grey, 0), "rb").read()
        _raises(tmp_path, "t2.png", data[:-20], "truncated")


# ------------------------------------------------------------------ fixtures
def write_fixtures(folder=FIXTURES):
    """The committed fixtures, from the port's seeded synthetic frames (H
    480, W 640 for the RGB-T pairs, crops of them for the edge cases), and
    manifest.json: per file the shape, dtype and SHA-256 of the JAX
    package's decode (`native.decode_jpeg` for JPEG, cv2.imread then
    BGR->RGB for PNG, and cv2.imread(path, -1) for the depth map)."""
    from multi_modal_tracking_torch.train.data.datasets.synthetic import SyntheticRGBT
    os.makedirs(folder, exist_ok=True)
    bgr = lambda a: cv2.cvtColor(a, cv2.COLOR_RGB2BGR)             # noqa: E731
    src = SyntheticRGBT(n_sequences=2, n_frames=2, H=480, W=640)
    files = {}
    for k in range(2):
        fv, fi, _ = src._seq(k)
        for tag, frame in (("v", fv[1]), ("i", fi[1])):
            files[f"pair{k}_{tag}.jpg"] = _jpeg(os.path.join(folder, f"pair{k}_{tag}.jpg"),
                                                bgr(frame), quality=95, sampling="420")
    frame = bgr(src._seq(0)[0][0])
    crop = cv2.GaussianBlur(frame[100:196, 120:248], (5, 5), 1.5)
    for name, kw in (("s444.jpg", dict(sampling="444")), ("s422.jpg", dict(sampling="422")),
                     ("s440.jpg", dict(sampling="440")), ("s411.jpg", dict(sampling="411")),
                     ("restart.jpg", dict(restart=2, quality=80)),
                     ("progressive.jpg", dict(progressive=True, quality=85))):
        files[name] = _jpeg(os.path.join(folder, name), crop, **kw)
    files["grey.jpg"] = _jpeg(os.path.join(folder, "grey.jpg"),
                              cv2.cvtColor(crop, cv2.COLOR_BGR2GRAY), quality=90)
    files["1x1.jpg"] = _jpeg(os.path.join(folder, "1x1.jpg"), crop[:1, :1])
    files["17x13.jpg"] = _jpeg(os.path.join(folder, "17x13.jpg"), crop[:13, :17])
    big = cv2.GaussianBlur(bgr(SyntheticRGBT(1, 1, 479, 641)._seq(0)[0][0]), (9, 9), 3)
    files["641x479.jpg"] = _jpeg(os.path.join(folder, "641x479.jpg"), big, quality=60)
    yy, xx = np.mgrid[0:120, 0:160]
    depth = (1200 + 9 * xx + 5 * yy + 400 * np.sin(xx / 9.0) * np.cos(yy / 13.0)).astype(np.uint16)
    files["depth16.png"] = write_png(os.path.join(folder, "depth16.png"), depth, 0, depth=16)
    palette = np.random.default_rng(0).integers(0, 256, (16, 3))
    index = ((xx[:48, :64] // 8 + yy[:48, :64] // 6) % 16).astype(np.uint8)
    files["palette.png"] = write_png(os.path.join(folder, "palette.png"), index, 3,
                                     palette=palette)
    manifest = {}
    for name, path in sorted(files.items()):
        entries = {}
        if name.endswith(".jpg"):
            entries["rgb"] = jax_native.decode_jpeg(path)
        else:
            entries["rgb"] = _cv2_rgb(path)
            if name.startswith("depth"):
                entries["unchanged"] = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        manifest[name] = {k: _digest(a) for k, a in entries.items()}
    with open(os.path.join(folder, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


def _digest(a):
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def test_committed_fixtures_match_the_manifest_and_both_readers():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    total = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES))
    assert total <= 1 << 20, total
    assert len(manifest) == 16
    for name, entries in manifest.items():
        path = os.path.join(FIXTURES, name)
        assert _digest(native.imread(path)) == entries["rgb"], name
        if name.endswith(".jpg"):
            assert _digest(jax_native.decode_jpeg(path)) == entries["rgb"], name
        assert _digest(_cv2_rgb(path)) == entries["rgb"], name
        if "unchanged" in entries:
            assert _digest(native.imread_unchanged(path)) == entries["unchanged"], name
            assert _digest(cv2.imread(path, cv2.IMREAD_UNCHANGED)) == entries["unchanged"], name


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        print(json.dumps(write_fixtures(), indent=1))
    else:
        print(__doc__)
