"""Metadata file resolution next to a data file.

Rebuild of the reference's CLI-convenience metadata guessing
(ref: python/src/ouster/sdk/util/metadata.py:85-123): given a pcap/bag
path, find the metadata json(s) sharing the longest filename prefix.
The underlying prefix search lives in io.pcap_source; this module
provides the reference-named public wrappers.
"""

from __future__ import annotations

import os
from typing import List, Optional

data_must_be_a_file_err = "The source parameter must be a path to a file."
meta_must_be_a_file_err = "The metadata parameter must be a path to a file."


def _check_duplicate_sensors(data_path: str, metas: List[str]) -> None:
    """Equal-prefix metadata files must describe DIFFERENT sensors
    (ref: util/metadata.py:13-36 _check_sensor_metadata_for_duplicates)."""
    from ..core.metadata import sensor_info_from_metadata

    serials = set()
    for meta in metas:
        sn = sensor_info_from_metadata(open(meta).read()).sn
        if sn in serials:
            raise RuntimeError("\n".join([
                "The following metadata files identified for "
                f"{data_path} contain configuration for the same sensor "
                f"{sn}. Files: {', '.join(sorted(set(metas)))} ",
                "To resolve this, remove the extra metadata file(s) or "
                "specify the metadata files manually using the --meta "
                "option."]))
        serials.add(sn)


def _resolve_checked(data_path: str) -> List[str]:
    # imported here: the io package imports ops, which imports this
    # package (utils.native)
    from ..io.pcap_source import resolve_metadata_paths

    if not os.path.isfile(data_path):
        raise ValueError(data_must_be_a_file_err)
    paths = resolve_metadata_paths(str(data_path))
    if len(paths) > 1:
        _check_duplicate_sensors(str(data_path), paths)
    return paths


def resolve_metadata(data_path: str,
                     meta_path: Optional[str] = None) -> Optional[str]:
    """Best-match metadata json for a data file, or the passed-through
    ``meta_path`` (ref: util/metadata.py:85-110)."""
    if meta_path is not None:
        if os.path.isfile(meta_path):
            return meta_path
        raise ValueError(meta_must_be_a_file_err)
    paths = _resolve_checked(data_path)
    return paths[0] if paths else None


def resolve_metadata_multi(data_path: str) -> List[str]:
    """All prefix-matched metadata jsons for a multi-sensor capture
    (ref: util/metadata.py:113-123)."""
    return _resolve_checked(data_path)
