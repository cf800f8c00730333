"""ROS bag ScanSource registration (reader in io/bag.py)."""

from .sources import IoType, ScanSourceOptions, register_scan_source


@register_scan_source(IoType.BAG)
@register_scan_source(IoType.MCAP)
def _build_bag_scan_source(source: str, opts: ScanSourceOptions):
    from .bag import BagScanSource

    return BagScanSource(
        source,
        meta=opts.take("meta"),
        soft_id_check=bool(opts.take("soft_id_check")),
        extrinsics=opts.take("extrinsics"),
        extrinsics_file=opts.take("extrinsics_file"),
        error_handler=opts.take("error_handler"),
    )


from .sources import register_packet_source  # noqa: E402


@register_packet_source(IoType.BAG)
@register_packet_source(IoType.MCAP)
def _build_bag_packet_source(source: str, opts: ScanSourceOptions):
    from .bag import BagPacketSource

    opts.take("error_handler")  # bags carry no schema version to gate
    return BagPacketSource(
        source,
        meta=opts.take("meta"),
        soft_id_check=bool(opts.take("soft_id_check")),
    )
