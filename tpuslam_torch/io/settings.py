"""Reference-compatible YAML settings (port of tpuslam/io/settings.py).

Parses the keys the reference reads with cv::FileStorage in the Tracking
ctor (src/Tracking.cc:52-315): Camera.type/fx/fy/cx/cy/k1-k4/p1/p2,
Camera.bf, Camera.fps, ORBextractor.{nFeatures,scaleFactor,nLevels,
iniThFAST,minThFAST}, ThDepth, DepthMapFactor, Tbc,
IMU.{Frequency,NoiseGyro,NoiseAcc,GyroWalk,AccWalk}, the fisheye rig's
Camera2.* / Tlr and the LEFT./RIGHT. rectification blocks, so the
reference's EuRoC / TUM / KITTI YAMLs work unmodified.

tpuslam reads the file with PyYAML; the port has its own reader of the
OpenCV-YAML subset those files use (`parse_opencv_yaml`): the `%YAML:1.0`
header, `#` comments, flat `key: value` lines, nested block mappings and
`!!opencv-matrix` blocks whose `data: [...]` flow list may span lines.
Plain scalars resolve as PyYAML's YAML 1.1 resolver does (so `2e-3`, with
no dot, stays a string while `1.7e-4` is a float, and yes/no/on/off are
booleans); quoted scalars stay strings. Anything outside the subset
raises ValueError.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np

from ..cameras import KannalaBrandt8, Pinhole
from ..engine.config import OrbConfig, SlamConfig
from ..imu.preintegration import ImuCalib
from ..utils import DEFAULT_DEVICE

# PyYAML's implicit resolvers (yaml/resolver.py), tried in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_UNSUPPORTED = re.compile(r"""^(?:<<|=
                          |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                          |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                           (?:[Tt]|[ \t]+)[0-9][0-9]?
                           :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                           (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value, cast):
    out, base = cast(0), 1
    for part in reversed(value.split(":")):
        out += cast(part) * base
        base *= 60
    return out


def resolve_plain(text: str):
    """A plain scalar's value as PyYAML's SafeLoader constructs it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if _NULL.match(text):
        return None
    if _UNSUPPORTED.match(text):
        raise ValueError(f"YAML scalar {text!r} (merge key, value key or timestamp) is not "
                         "supported")
    return text


class _Reader:
    """One pass over the lines of an OpenCV-YAML document."""

    def __init__(self, text: str):
        self.lines = text.split("\n")
        self.i = 0

    def fail(self, msg):
        raise ValueError(f"settings YAML line {self.i + 1}: {msg}")

    # -- lines
    def next_content(self):
        """Index of the next line holding content (not blank, not a comment)."""
        j = self.i
        while j < len(self.lines):
            s = self.lines[j].strip()
            if s and not s.startswith("#") and s != "---":
                return j
            j += 1
        return j

    @staticmethod
    def indent(line):
        return len(line) - len(line.lstrip(" "))

    # -- scalars inside one string `s` from position `p`
    def quoted(self, s, p):
        """(value, end) of the quoted scalar starting at s[p]."""
        q = s[p]
        out, p = [], p + 1
        while p < len(s) and s[p] != "\n":
            c = s[p]
            if q == "'" and c == "'":
                if s[p + 1:p + 2] == "'":
                    out.append("'")
                    p += 2
                    continue
                return "".join(out), p + 1
            if q == '"' and c == '"':
                return "".join(out), p + 1
            if q == '"' and c == "\\":
                e = s[p + 1:p + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    p += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    out.append(chr(int(s[p + 2:p + 2 + n], 16)))
                    p += 2 + n
                    continue
                self.fail(f"unknown escape \\{e}")
            out.append(c)
            p += 1
        self.fail("quoted scalar not closed on its line")

    def flow(self, s, p):
        """(value, end) of the flow node at s[p] (a sequence or a scalar)."""
        p = self.skip(s, p)
        if p >= len(s):
            self.fail("flow sequence not closed")
        c = s[p]
        if c == "[":
            items, p = [], self.skip(s, p + 1)
            while True:
                if p >= len(s):
                    self.fail("flow sequence not closed")
                if s[p] == "]":
                    return items, p + 1
                v, p = self.flow(s, p)
                items.append(v)
                p = self.skip(s, p)
                if p < len(s) and s[p] == ",":
                    p = self.skip(s, p + 1)
                elif p < len(s) and s[p] != "]":
                    self.fail(f"unexpected {s[p]!r} in a flow sequence")
        if c in "{&*!|>":
            self.fail(f"{c!r} (flow mappings, anchors, tags, block scalars) is not supported")
        if c in "'\"":
            return self.quoted(s, p)
        q = p
        while q < len(s) and s[q] not in ",[]{}\n" and not (s[q] == "#" and s[q - 1] in " \t"):
            q += 1
        return resolve_plain(s[p:q].strip()), q

    @staticmethod
    def skip(s, p):
        """Past blanks, line breaks and comments."""
        while p < len(s):
            if s[p] in " \t\n\r":
                p += 1
            elif s[p] == "#" and (p == 0 or s[p - 1].isspace()):
                while p < len(s) and s[p] != "\n":
                    p += 1
            else:
                break
        return p

    # -- block structure
    def mapping(self, indent):
        """The block mapping whose entries start at column `indent`."""
        out = {}
        while True:
            j = self.next_content()
            if j >= len(self.lines):
                return out
            line = self.lines[j]
            ind = self.indent(line)
            if ind < indent:
                return out
            self.i = j
            if ind > indent:
                self.fail("unexpected indentation")
            body = line[ind:]
            if body.startswith("- ") or body == "-":
                self.fail("block sequences are not supported")
            if body[0] in "'\"":
                key, p = self.quoted(body, 0)
            else:
                m = re.search(r":(?:\s|$)", body)
                if m is None:
                    self.fail(f"no 'key: value' in {body!r}")
                key, p = resolve_plain(body[: m.start()].rstrip()), m.start()
            p = self.skip_blanks(body, p)
            if body[p:p + 1] != ":":
                self.fail(f"no ':' after key {key!r}")
            out[key] = self.value(body, p + 1, indent)

    @staticmethod
    def skip_blanks(s, p):
        while p < len(s) and s[p] in " \t":
            p += 1
        return p

    def value(self, body, p, indent):
        """The value after `key:` on the current line; a nested block
        mapping or a flow sequence continues on the lines below."""
        p = self.skip_blanks(body, p)
        rest = body[p:]
        tagged = rest.startswith("!!")
        if tagged:
            tag = rest.split()[0]
            if tag != "!!opencv-matrix":
                self.fail(f"tag {tag} is not supported")
            rest = rest[len(tag):].lstrip(" \t")
        if not rest or rest.startswith("#"):
            self.i += 1
            j = self.next_content()
            if j < len(self.lines) and self.indent(self.lines[j]) > indent:
                return self.mapping(self.indent(self.lines[j]))
            if tagged:
                self.fail("an !!opencv-matrix tag without its block")
            return None
        if tagged:
            self.fail("an !!opencv-matrix value must be a block mapping")
        if rest[0] == "[":
            text = "\n".join([rest] + self.lines[self.i + 1:])
            v, end = self.flow(text, 0)
            self.i += text.count("\n", 0, end)
            tail = text[end:].split("\n", 1)[0]
        elif rest[0] in "'\"":
            v, end = self.quoted(rest, 0)
            tail = rest[end:]
        else:
            if rest[0] in "{&*!|>%@`" or rest == "-" or rest.startswith("- "):
                self.fail(f"{rest[0]!r} (flow mappings, sequences, anchors, tags, block "
                          "scalars) is not supported")
            m = re.search(r"\s#", rest)
            text = (rest[: m.start()] if m else rest).rstrip()
            if re.search(r":(?:\s|$)", text):
                self.fail(f"mapping values are not allowed in {text!r}")
            v, tail = resolve_plain(text), ""
        if tail.strip() and not (tail[:1] in " \t" and tail.strip().startswith("#")):
            self.fail(f"unexpected {tail.strip()!r} after the value")
        self.i += 1
        j = self.next_content()
        if j < len(self.lines) and self.indent(self.lines[j]) > indent:
            self.i = j
            self.fail("multi-line scalars are not supported")
        return v


def parse_opencv_yaml(text: str) -> dict:
    """The mapping an OpenCV-YAML settings file holds, as tpuslam's PyYAML
    loader gives it (`!!opencv-matrix` blocks as plain dicts)."""
    text = "\n".join(ln for ln in text.splitlines() if not ln.startswith("%YAML"))
    reader = _Reader(text)
    out = reader.mapping(0)
    if reader.next_content() < len(reader.lines):
        reader.i = reader.next_content()
        reader.fail("unexpected content")
    return out


def _parse_opencv_matrix(node):
    if isinstance(node, dict) and "data" in node:
        return np.array(node["data"], np.float64).reshape(
            int(node["rows"]), int(node["cols"]))
    return np.asarray(node, np.float64)


@dataclass
class Settings:
    camera: object
    cfg: SlamConfig
    bf: float
    fps: float
    imu_calib: ImuCalib | None
    Tbc: np.ndarray | None
    raw: dict
    rectification: dict | None = None  # {left: {K,D,R,P}, right: {...},
    #                                     height, width} (ref LEFT./RIGHT.)
    camera2: object | None = None      # fisheye rig right camera (Camera2.*)
    Tlr: np.ndarray | None = None      # left<-right 4x4 (ref Tlr)

    @property
    def has_imu(self):
        return self.imu_calib is not None

    def make_rectifier(self, device=DEFAULT_DEVICE):
        """StereoRectifier from the LEFT./RIGHT. blocks, its maps on
        `device`, or None (ref: the stereo drivers'
        initUndistortRectifyMap stage)."""
        if self.rectification is None:
            return None
        from .rectify import StereoRectifier
        r = self.rectification
        return StereoRectifier(r["left"], r["right"], r["height"], r["width"], device=device)


def load_settings(path: str, width: int | None = None,
                  height: int | None = None) -> Settings:
    """The settings file at `path`; width / height give the image size where
    the file has no Camera.width / Camera.height (and raise without it)."""
    with open(path) as fh:
        raw = parse_opencv_yaml(fh.read())

    def get(key, default=None):
        return raw.get(key, default)

    cam_type = str(get("Camera.type", "PinHole"))
    fx = float(get("Camera.fx"))
    fy = float(get("Camera.fy"))
    cx = float(get("Camera.cx"))
    cy = float(get("Camera.cy"))
    # the image size: the file's, else the caller's (run.py passes its first
    # image's, as the reference's frames take their bounds from the image);
    # tpuslam falls back to EuRoC's 752x480, which would clip a KITTI frame
    w, h = get("Camera.width", width), get("Camera.height", height)
    if w is None or h is None:
        raise ValueError(f"{path}: no Camera.width / Camera.height; pass the image size "
                         "(load_settings(path, width, height))")
    w, h = int(w), int(h)
    if cam_type.lower() in ("kannalabrandt8", "kb8", "fisheye"):
        k = [float(get(f"Camera.k{i}", 0.0)) for i in (1, 2, 3, 4)]
        lap = None
        if get("Camera.lappingBegin") is not None:
            lap = (int(get("Camera.lappingBegin")),
                   int(get("Camera.lappingEnd", w)))
        camera = KannalaBrandt8([fx, fy, cx, cy, *k], w, h, lapping=lap)
    else:
        camera = Pinhole(
            [fx, fy, cx, cy], w, h,
            dist=[float(get("Camera.k1", 0.0)), float(get("Camera.k2", 0.0)),
                  float(get("Camera.p1", 0.0)), float(get("Camera.p2", 0.0)),
                  float(get("Camera.k3", 0.0))],
        )
    orb = OrbConfig(
        n_features=int(get("ORBextractor.nFeatures", 1000)),
        scale=float(get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(get("ORBextractor.nLevels", 8)),
        ini_th=float(get("ORBextractor.iniThFAST", 20)),
        min_th=float(get("ORBextractor.minThFAST", 7)),
    )
    cfg = SlamConfig(orb=orb)
    cfg.th_depth = float(get("ThDepth", get("Camera.ThDepth", 35.0)))
    # metres per raw depth unit, applied once by the tracker to the depth
    # image as read (ref: Tracking.cc mDepthMapFactor = 1 / DepthMapFactor,
    # 1 where it is 0; GrabImageRGBD scales the raw image by it). tpuslam
    # keeps DepthMapFactor itself and divides the image by it in run.py
    # before its tracker multiplies by it again.
    dmf = float(get("DepthMapFactor", 1.0))
    cfg.depth_map_factor = 1.0 / dmf if abs(dmf) > 1e-5 else 1.0
    fps = float(get("Camera.fps", 30.0))
    cfg.tracking.max_frames_between_kf = int(round(fps))
    bf = float(get("Camera.bf", 0.0))
    imu_calib = None
    Tbc = None
    if get("IMU.Frequency") is not None:
        imu_calib = ImuCalib(
            noise_gyro=float(get("IMU.NoiseGyro", 1.7e-4)),
            noise_acc=float(get("IMU.NoiseAcc", 2e-3)),
            walk_gyro=float(get("IMU.GyroWalk", 1.9e-5)),
            walk_acc=float(get("IMU.AccWalk", 3e-3)),
            freq=float(get("IMU.Frequency", 200.0)),
        )
        if get("Tbc") is not None:
            Tbc = _parse_opencv_matrix(get("Tbc"))
            imu_calib.Tbc = Tbc
    # stereo rectification blocks (ref: Tracking.cc:274-295 LEFT./RIGHT.
    # {K, D, R, P, height, width} for non-prerectified stereo pairs)
    rect = None
    if get("LEFT.K") is not None and get("RIGHT.K") is not None:
        def side(prefix):
            return dict(
                K=_parse_opencv_matrix(get(f"{prefix}.K")),
                D=_parse_opencv_matrix(get(f"{prefix}.D")).reshape(-1),
                R=_parse_opencv_matrix(get(f"{prefix}.R")),
                P=_parse_opencv_matrix(get(f"{prefix}.P")),
            )
        rect = dict(
            left=side("LEFT"), right=side("RIGHT"),
            height=int(get("LEFT.height", h)),
            width=int(get("LEFT.width", w)),
        )
    # fisheye stereo rig: second KB8 camera + left<-right extrinsic
    # (ref: Tracking.cc:95-134 parses Camera2.*, Tlr, lapping areas for
    # the KannalaBrandt8 stereo configuration, e.g. TUM_512.yaml)
    camera2 = None
    Tlr = None
    if get("Camera2.fx") is not None:
        k2 = [float(get(f"Camera2.k{i}", 0.0)) for i in (1, 2, 3, 4)]
        lap2 = None
        if get("Camera2.lappingBegin") is not None:
            lap2 = (int(get("Camera2.lappingBegin")),
                    int(get("Camera2.lappingEnd", w)))
        camera2 = KannalaBrandt8(
            [float(get("Camera2.fx")), float(get("Camera2.fy")),
             float(get("Camera2.cx")), float(get("Camera2.cy")), *k2],
            w, h, lapping=lap2)
        if get("Tlr") is not None:
            T = _parse_opencv_matrix(get("Tlr"))
            Tlr = np.eye(4)
            Tlr[: T.shape[0], : T.shape[1]] = T
    return Settings(camera=camera, cfg=cfg, bf=bf, fps=fps,
                    imu_calib=imu_calib, Tbc=Tbc, raw=raw,
                    rectification=rect, camera2=camera2, Tlr=Tlr)
