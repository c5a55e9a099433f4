"""Leveled logging (ref: class Verbose, include/System.h:47-72 —
VERBOSITY_QUIET/NORMAL/VERBOSE/VERY_VERBOSE/DEBUG with PrintMess gated on
the process-wide threshold; the reference sets QUIET in the System ctor,
System.cc:224)."""

from __future__ import annotations

import enum
import sys


class Level(enum.IntEnum):
    QUIET = 0
    NORMAL = 1
    VERBOSE = 2
    VERY_VERBOSE = 3
    DEBUG = 4


_TH = Level.QUIET  # ref default (System.cc:224)


def set_level(level: Level | int | str):
    global _TH
    if isinstance(level, str):
        level = Level[level.upper()]
    _TH = Level(level)


def get_level() -> Level:
    return _TH


def print_mess(msg: str, level: Level | int = Level.NORMAL):
    """ref: Verbose::PrintMess."""
    if Level(level) <= _TH:
        print(msg, file=sys.stderr)
