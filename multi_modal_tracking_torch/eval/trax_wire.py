"""TraX text wire protocol, the byte format the VOT toolkit speaks: the
port's own copy of the JAX package's `eval/trax_wire.py`.

The reference integrates VOT through the compiled ``trax`` python package
(lib/test/vot20/vot.py:14); this module implements the tracker side of the
underlying TEXT protocol (TraX protocol version 3, as documented in the TraX
reference implementation) so the experiment loop can talk to the toolkit over
stdin/stdout with no compiled dependency (transcript-replay tests:
tests/test_torch_port_vot.py, on tests/test_vot_wire.py's transcripts).

The wire reports rectangles only: a mask given to `TraxWireServer.status`
raises ValueError (the VOT2020 mask entry needs the ``trax`` package or an
injected server that takes masks).

Wire format (one message per line):

    @@TRAX:<name> <arg> <arg> ... <key=value> ...

* Arguments containing whitespace, quotes or backslashes are wrapped in
  double quotes with ``\\"`` / ``\\\\`` escapes.
* tracker -> toolkit: ``hello`` once at startup (capability properties:
  trax.version, trax.region, trax.image, trax.channels, custom metadata),
  then one ``state <region> [props]`` per request.
* toolkit -> tracker: ``initialize <image>.. <region> [props]``,
  ``frame <image>.. [props]``, ``quit`` — one image argument per declared
  channel, in hello's channel order.
* rectangle region: ``"x,y,width,height"``; path image: the file path
  (a ``file://`` prefix is tolerated and stripped).
"""
from __future__ import annotations

import numbers
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

_PREFIX = "@@TRAX:"


def _escape(arg: str) -> str:
    if arg == "" or any(c in arg for c in ' \t"\\'):
        return '"' + arg.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return arg


def encode_message(name: str, args: Sequence[str] = (),
                   properties: Optional[dict] = None) -> str:
    parts = [_PREFIX + name]
    parts += [_escape(str(a)) for a in args]
    for k, v in (properties or {}).items():
        parts.append(_escape(f"{k}={v}"))
    return " ".join(parts)


def parse_message(line: str) -> Tuple[str, List[str], dict]:
    """-> (name, positional_args, properties). Raises ValueError on a
    non-TraX line (the toolkit may interleave logging on the same stream)."""
    line = line.rstrip("\r\n")
    if not line.startswith(_PREFIX):
        raise ValueError(f"not a TraX message: {line!r}")
    rest = line[len(_PREFIX):]
    name, _, tail = rest.partition(" ")
    tokens: List[str] = []
    buf, quoted, escaped, in_token = [], False, False, False
    for ch in tail:
        if escaped:
            buf.append(ch)
            escaped = False
        elif ch == "\\":
            escaped = True
            in_token = True
        elif ch == '"':
            quoted = not quoted
            in_token = True
        elif ch in " \t" and not quoted:
            if in_token:
                tokens.append("".join(buf))
                buf, in_token = [], False
        else:
            buf.append(ch)
            in_token = True
    if in_token:
        tokens.append("".join(buf))
    if quoted:
        raise ValueError(f"unterminated quote in TraX message: {line!r}")
    args, props = [], {}
    for t in tokens:
        k, eq, v = t.partition("=")
        # a property key is a bare word (first '=' splits key/value); region
        # and path arguments never contain '=' before any separator
        if eq and k and all(c.isalnum() or c in "._-" for c in k):
            props[k] = v
        else:
            args.append(t)
    return name, args, props


def encode_rectangle(x: float, y: float, w: float, h: float) -> str:
    return f"{float(x):.4f},{float(y):.4f},{float(w):.4f},{float(h):.4f}"


def parse_region(arg: str) -> Tuple[float, float, float, float]:
    """Rectangle 'x,y,w,h'; a polygon (>= 6 coords) is reduced to its
    axis-aligned bounds like trax.Region.bounds()."""
    vals = [float(v) for v in arg.split(",") if v != ""]
    if len(vals) == 4:
        return tuple(vals)  # type: ignore[return-value]
    if len(vals) >= 6 and len(vals) % 2 == 0:
        xs, ys = vals[0::2], vals[1::2]
        return min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)
    raise ValueError(f"unsupported region encoding: {arg!r}")


def _strip_path(arg: str) -> str:
    return arg[len("file://"):] if arg.startswith("file://") else arg


@dataclass
class _Request:
    type: str
    region: Optional[Tuple[float, float, float, float]] = None
    image: List[str] = field(default_factory=list)
    properties: dict = field(default_factory=dict)


class TraxWireServer:
    """Tracker-side TraX text-protocol endpoint over a stream pair.

    Drop-in for the ``server=`` injection point of eval/vot.py VOTClient:
    wait() -> request with .type/.region/.image, status(region[, props]),
    quit().  Defaults to stdin/stdout — the transport the VOT toolkit uses
    when it launches a tracker command (trackers.ini)."""

    def __init__(self, channels: Sequence[str] = ("color",),
                 metadata: Optional[dict] = None, fin=None, fout=None):
        self._fin = fin if fin is not None else sys.stdin
        self._fout = fout if fout is not None else sys.stdout
        self._channels = list(channels)
        props = {
            "trax.version": 3,
            "trax.region": "rectangle",
            "trax.image": "path",
            "trax.channels": ",".join(self._channels),
        }
        props.update(metadata or {"vot": "python"})
        self._send("hello", (), props)
        self._done = False

    def _send(self, name, args=(), properties=None):
        self._fout.write(encode_message(name, args, properties) + "\n")
        self._fout.flush()

    def wait(self) -> _Request:
        if self._done:
            return _Request(type="quit")
        while True:
            line = self._fin.readline()
            if not line:          # EOF == quit (toolkit died / closed pipe)
                self._done = True
                return _Request(type="quit")
            try:
                name, args, props = parse_message(line)
            except ValueError:
                continue          # ignore non-protocol chatter on the stream
            if name == "quit":
                self._done = True
                return _Request(type="quit", properties=props)
            if name == "initialize":
                n = len(self._channels)
                if len(args) < n + 1:
                    raise ValueError(f"initialize needs {n} image args + "
                                     f"region, got {args!r}")
                return _Request(type="initialize",
                                region=parse_region(args[n]),
                                image=[_strip_path(a) for a in args[:n]],
                                properties=props)
            if name == "frame":
                n = len(self._channels)
                if len(args) < n:
                    raise ValueError(f"frame needs {n} image args, "
                                     f"got {args!r}")
                return _Request(type="frame",
                                image=[_strip_path(a) for a in args[:n]],
                                properties=props)
            raise ValueError(f"unexpected TraX message {name!r}")

    def status(self, region, properties=None):
        if region is None:
            raise ValueError("status requires a region")
        if hasattr(region, "x"):      # Rectangle namedtuple
            rect = (region.x, region.y, region.width, region.height)
        else:
            rect = tuple(region) if getattr(region, "ndim", 1) == 1 else ()
        if len(rect) != 4 or not all(isinstance(v, numbers.Real) for v in rect):
            raise ValueError("TraxWireServer.status: the wire reports rectangles only "
                             "(x, y, width, height); a mask needs the trax package or an "
                             f"injected server that takes masks (got {type(region).__name__} "
                             f"of shape {getattr(region, 'shape', len(rect))})")
        props = dict(properties or {})
        if "confidence" in props and props["confidence"] is not None:
            props["confidence"] = f"{float(props['confidence']):.6f}"
        self._send("state", (encode_rectangle(*rect),), props)

    def quit(self):
        self._done = True
