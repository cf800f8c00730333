"""Minimal NMEA RMC parsing for POSITION_LAT_LONG
(ref: ouster_client/src/parsing.cpp:954-974 + thirdparty/nmea:
sentence.cpp validate/checksum, parse.cpp parse_latitude/longitude,
rmc.cpp — matched exactly: checksum REQUIRED and verified, no status
gate, fixed-width degree fields (lat 2, lon 3), minutes parsed from the
remaining substring)."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union


def _validate(sentence: str) -> Optional[str]:
    """Reference nmea::sentence::validate: $/! start, '*hh' checksum
    present and equal to the XOR of the body. Returns the body (between
    the leading char and '*') or None."""
    if len(sentence) < 4 or sentence[0] not in "$!":
        return None
    star = sentence.rfind("*")
    if star < 0 or len(sentence) < star + 3:
        return None
    checksum = 0
    for ch in sentence[1:star]:
        checksum ^= ord(ch)
    if sentence[star + 1:star + 3].upper() != f"{checksum:02X}":
        return None
    return sentence[1:star]


def _coord(value: str, hemi: str, deg_width: int) -> float:
    """NMEA d{deg_width}mm.mmmm -> decimal degrees, parsed like the
    reference: degrees from the fixed-width prefix, minutes from the
    remaining substring (ref: parse.cpp:101-152)."""
    if not value or not hemi:
        raise ValueError("empty coordinate")
    degrees = float(value[:deg_width])
    minutes = float(value[deg_width:])
    dec = degrees + minutes / 60.0
    if hemi in ("S", "W"):
        dec = -dec
    return dec


def parse_lat_long(sentence: Union[bytes, str]) -> Tuple[float, float]:
    """Parse an $G?RMC sentence to (lat, lon); NaNs when absent or the
    checksum fails."""
    if isinstance(sentence, bytes):
        sentence = sentence.split(b"\x00", 1)[0].decode(
            "ascii", errors="replace")
    sentence = sentence.strip()
    nan = (math.nan, math.nan)
    body = _validate(sentence)
    if body is None:
        return nan
    parts = body.split(",")
    if len(parts) < 7 or not parts[0].endswith("RMC"):
        return nan
    # RMC: [0] talker+RMC, [1] time, [2] status, [3] lat, [4] N/S,
    #      [5] lon, [6] E/W, ... (status is NOT gated, like the
    #      reference rmc.cpp: coordinates are taken whenever present)
    try:
        lat = _coord(parts[3], parts[4], 2)
        lon = _coord(parts[5], parts[6], 3)
    except (ValueError, IndexError):
        return nan
    return lat, lon
