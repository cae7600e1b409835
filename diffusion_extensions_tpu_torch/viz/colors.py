"""The figures' colours, as hex codes and as float RGB triples."""
from __future__ import annotations

import struct

BLUE = "#1f77b4"
ORANGE = "#ff7f0e"
GREEN = "#2ca02c"
BLACK = "#000000"
WHITE = "#FFFFFF"
GREY = "#888888"


def _to_float(hexcode: str) -> tuple[float, float, float]:
    return tuple(i / 255 for i in struct.unpack("BBB", bytes.fromhex(hexcode[1:])))


BLUE_F = _to_float(BLUE)
ORANGE_F = _to_float(ORANGE)
GREEN_F = _to_float(GREEN)
BLACK_F = _to_float(BLACK)
WHITE_F = _to_float(WHITE)
GREY_F = _to_float(GREY)
