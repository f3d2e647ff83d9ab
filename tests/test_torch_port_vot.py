"""The port's VOT entries (eval/vot.py) and TraX wire (eval/trax_wire.py) on
the CPU against the JAX package's.

The wire: tests/test_vot_wire.py's transcripts replayed through both
packages' servers give the same requests and the same bytes; a mask given
to the port's `status` raises ValueError (the JAX wire raises a bare
TypeError there). The entries: `run_vot_exp` (RGBD: colour PNGs and
16-bit depth PNGs, the score-gated online tracker of
tests/test_torch_port_online_tracker.py), `run_vot20_lt_exp` and
`run_vot20_mask_exp` (the cached unimodal tracker of
tests/test_torch_port_unimodal.py, Alpha-Refine at input 64 from
tests/torch_port_alpha_refine_common.py), each fed by one fake server
(the JAX test's duck type) on the same files in both packages.

Tolerances: rectangles within the 0.02 px of the tracker tests,
confidences 1e-4 (2e-4 on the RGBD entry, whose candidates are committed
every third frame, so the score branch reads templates that differ by
the trackers' rounding); the VOT2020 masks differ on at most 0.1% of a
frame's pixels. With random weights Alpha-Refine's sigmoid stays below
the entry's 0.6, so the mask test thresholds at the median of the port's
first crop mask (the entries take `mask_threshold`).
"""
import io

import cv2
import numpy as np
import pytest

from multi_modal_tracking_tpu.eval import trax_wire as jax_wire
from multi_modal_tracking_tpu.eval import vot as jax_vot
from multi_modal_tracking_tpu.tracking import tracker as jax_tracker

from multi_modal_tracking_torch.eval import trax_wire as port_wire
from multi_modal_tracking_torch.eval import vot as port_vot
from multi_modal_tracking_torch.models.alpha_refine import ARcmSeg
from multi_modal_tracking_torch.tracking import tracker

from tests import torch_port_alpha_refine_common as common
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)


# --------------------------------------------------------------------- wire
TRANSCRIPTS = {
    "multichannel": (("color", "ir"), [
        '@@TRAX:initialize "/d/seq 01/color/0001.jpg" "/d/seq 01/ir/0001.jpg" '
        '"10.0,20.0,30.0,40.0"',
        "random toolkit logging that must be ignored",
        '@@TRAX:frame file:///d/seq%2001.jpg "/d/seq 01/ir/0002.jpg"',
        "@@TRAX:quit"]),
    "eof_is_quit": (("color", "ir"), ['@@TRAX:initialize "a.jpg" "b.jpg" "1,2,3,4"']),
    "polygon_color": (("color",), [
        '@@TRAX:initialize /x/1.png "0,0,10,0,10,6,0,6" trax.timestamp=3',
        '@@TRAX:frame "/x/my 2.png" trax.timestamp=4',
        "@@TRAX:quit"]),
}


def _replay(wire, channels, lines):
    """Replay a transcript through one package's server, answering every
    request with a state; returns (requests, emitted lines)."""
    fin, fout = io.StringIO("".join(l + "\n" for l in lines)), io.StringIO()
    server = wire.TraxWireServer(channels=channels, fin=fin, fout=fout)
    reqs = []
    while True:
        r = server.wait()
        reqs.append((r.type, r.region, list(r.image), dict(r.properties)))
        if r.type == "quit":
            break
        box = r.region if r.region is not None else (1.5, 2.25, 3.0, 4.0)
        server.status(box, {"confidence": 0.875})
    return reqs, fout.getvalue().splitlines()


@pytest.mark.parametrize("name", list(TRANSCRIPTS))
def test_wire_replays_like_jax(name):
    channels, lines = TRANSCRIPTS[name]
    got = _replay(port_wire, channels, lines)
    assert got == _replay(jax_wire, channels, lines)
    assert port_wire.parse_message(got[1][0])[0] == "hello"


def test_wire_messages_like_jax():
    args = ['/data/my seq/00000001.jpg', '/data/weird"name\\x.png', ""]
    line = port_wire.encode_message("frame", args, {"trax.timestamp": "17.5"})
    assert line == jax_wire.encode_message("frame", args, {"trax.timestamp": "17.5"})
    assert port_wire.parse_message(line) == jax_wire.parse_message(line)
    assert port_wire.parse_region("0,0,10,0,10,6,0,6") == (0.0, 0.0, 10.0, 6.0)
    with pytest.raises(ValueError, match="not a TraX message"):
        port_wire.parse_message("hello")


def test_wire_rejects_a_mask():
    """The one message that changes: the JAX wire raises TypeError from
    encode_rectangle; the port's says the wire is rectangle-only."""
    server = port_wire.TraxWireServer(fin=io.StringIO(""), fout=io.StringIO())
    mask = np.zeros((6, 8), np.uint8)
    with pytest.raises(TypeError):
        jax_wire.TraxWireServer(fin=io.StringIO(""), fout=io.StringIO()).status(mask)
    with pytest.raises(ValueError, match="rectangles only"):
        server.status(mask)
    with pytest.raises(ValueError, match="rectangles only"):
        server.status([[1, 2, 3, 4]] * 4)
    server.status(np.asarray([1.0, 2.0, 3.0, 4.0]))


# ------------------------------------------------------------------ entries
class _FakeRequest:
    def __init__(self, typ, region=None, image=None):
        self.type, self.region, self.image = typ, region, image


class _FakeServer:
    """Duck-typed trax server: initialize -> frames -> quit, recording
    every status."""

    def __init__(self, paths, region):
        self.reports = []
        self._queue = [_FakeRequest("initialize", region=region, image=paths[0])]
        self._queue += [_FakeRequest("frame", image=p) for p in paths[1:]]
        self._queue.append(_FakeRequest("quit"))
        self.quit_called = False

    def wait(self):
        return self._queue.pop(0)

    def status(self, region, props=None):
        self.reports.append((region, dict(props or {})))

    def quit(self):
        self.quit_called = True


def _rects(server):
    return np.asarray([[r.x, r.y, r.width, r.height] for r, _ in server.reports[1:]])


def _conf(server):
    return np.asarray([p["confidence"] for _, p in server.reports[1:]])


def _rgbd_files(tmp_path, n=5):
    """Colour PNGs of the online tracker test's moving square and 16-bit
    depth PNGs with a nearer square."""
    from tests.test_torch_port_online_tracker import _sequence
    seq, _ = _sequence("vot", 0, n)
    rng = np.random.default_rng(1)
    paths = []
    for k, (fv, _) in enumerate(seq.frames):
        pc, pd = str(tmp_path / f"c_{k}.png"), str(tmp_path / f"d_{k}.png")
        cv2.imwrite(pc, fv[..., ::-1])
        depth = rng.integers(3000, 4000, fv.shape[:2]).astype(np.uint16)
        x, y = (int(v) for v in seq.ground_truth_rect[k][0][:2])
        depth[y:y + 48, x:x + 48] = 1200
        cv2.imwrite(pd, depth)
        paths.append([pc, pd])
    return paths, tuple(float(v) for v in seq.ground_truth_rect[0][0])


def _color_files(tmp_path, n=6):
    frames, boxes = common.frame_sequence(n, seed=2)
    paths = []
    for k, f in enumerate(frames):
        p = str(tmp_path / f"f_{k}.png")
        cv2.imwrite(p, f[..., ::-1])
        paths.append(p)
    return paths, tuple(boxes[0])


@pytest.fixture(scope="module")
def unimodal():
    from tests.test_torch_port_unimodal import KW, _pair
    jm, variables, pm = _pair(2, bias=-1.0)
    return (lambda: jax_tracker.RGBCachedTrackerJit(model=jm, variables=variables,
                                                    update_interval=3, mode="RGB", **KW),
            lambda: tracker.RGBCachedTracker(pm, update_interval=3, mode="RGB", device="cpu",
                                             **KW))


#: the score head's last bias: scores on both sides of 0.5 on the RGBD files
RGBD_SCORE_BIAS = -0.25


def test_rgbd_entry_matches_jax(tmp_path):
    from tests.test_torch_port_online_tracker import KW
    from tests.test_torch_port_spm import score_pair
    jm, variables, pm = score_pair(3, bias=RGBD_SCORE_BIAS)
    paths, region = _rgbd_files(tmp_path)
    servers = [_FakeServer(paths, region) for _ in range(2)]
    jax_vot.run_vot_exp("asymmetric_shared_online", channels="rgbd", server=servers[0],
                        tracker=jax_tracker.RGBTOnlineCachedTrackerJit(
                            model=jm, variables=variables, **KW))
    port_vot.run_vot_exp("asymmetric_shared_online", channels="rgbd", server=servers[1],
                         tracker=tracker.RGBTOnlineCachedTracker(pm, device="cpu", **KW))
    want, got = servers
    assert got.quit_called and len(got.reports) == len(want.reports) == len(paths)
    assert got.reports[0][0] == want.reports[0][0] == region
    np.testing.assert_allclose(_rects(got), _rects(want), atol=0.02, rtol=0)
    np.testing.assert_allclose(_conf(got), _conf(want), atol=2e-4, rtol=0)
    assert (_conf(want) > 0.5).any() and (_conf(want) < 0.5).any(), _conf(want)


def test_lt_entry_matches_jax(tmp_path, unimodal):
    paths, region = _color_files(tmp_path)
    servers = [_FakeServer(paths, region) for _ in range(2)]
    jax_vot.run_vot20_lt_exp("mixformer_vit", server=servers[0], tracker=unimodal[0]())
    port_vot.run_vot20_lt_exp("mixformer_vit", server=servers[1], tracker=unimodal[1]())
    want, got = servers
    assert all(isinstance(r, port_vot.Rectangle) for r, _ in got.reports[1:])
    np.testing.assert_allclose(_rects(got), _rects(want), atol=0.02, rtol=0)
    np.testing.assert_allclose(_conf(got), _conf(want), atol=1e-4, rtol=0)


def test_mask_entry_matches_jax(tmp_path, unimodal):
    paths, region = _color_files(tmp_path)
    servers = [_FakeServer(paths, region) for _ in range(2)]
    refiner = ARcmSeg(common.port_alpha_refine())
    frames, _ = common.frame_sequence(2, seed=2)
    refiner.initialize(frames[0], region)
    thr = float(refiner.mask_crop(frames[1], region).median())
    jax_vot.run_vot20_mask_exp("mixformer_vit", server=servers[0], tracker=unimodal[0](),
                               refiner=jax_ar_refiner(), mask_threshold=thr)
    port_vot.run_vot20_mask_exp("mixformer_vit", server=servers[1], tracker=unimodal[1](),
                                refiner=refiner, mask_threshold=thr)
    want, got = servers
    assert got.quit_called and len(got.reports) == len(paths)
    for (g, gp), (w, wp) in zip(got.reports[1:], want.reports[1:], strict=True):
        assert g.shape == w.shape == (120, 160) and g.dtype == np.uint8
        assert set(np.unique(g)) <= {0, 1}
        assert np.mean(g != w) <= 1e-3
        assert gp == wp
    assert all(0.001 < g.mean() < 0.5 for g, _ in got.reports[1:])


def jax_ar_refiner():
    """The shared JAX ARcmSeg, re-initialised by the entry."""
    return common.jax_ar_seg()


def test_mask_entry_over_the_port_wire_raises(tmp_path, unimodal):
    """Without the trax package the port's wire cannot carry the mask: the
    first report raises the rectangle-only ValueError."""
    paths, region = _color_files(tmp_path, n=2)
    x, y, w, h = region
    fin = io.StringIO(f'@@TRAX:initialize {paths[0]} "{x},{y},{w},{h}"\n'
                      f"@@TRAX:frame {paths[1]}\n@@TRAX:quit\n")
    server = port_wire.TraxWireServer(channels=("color",), fin=fin, fout=io.StringIO())
    with pytest.raises(ValueError, match="rectangles only"):
        port_vot.run_vot20_mask_exp("mixformer_vit", server=server, tracker=unimodal[1](),
                                    refiner=ARcmSeg(common.port_alpha_refine()))
