"""OSF ScanSource registration (the reader, writer and source are in
io/osf.py)."""

from .sources import IoType, ScanSourceOptions, register_scan_source


@register_scan_source(IoType.OSF)
def _build_osf_scan_source(source: str, opts: ScanSourceOptions):
    from .osf import OsfScanSource

    return OsfScanSource(
        source,
        field_names=opts.take("field_names"),
        extrinsics=opts.take("extrinsics"),
        extrinsics_file=opts.take("extrinsics_file"),
        index=opts.take("index"),
        error_handler=opts.take("error_handler"),
        device=opts.take("device"),
    )
