"""Live sensor ScanSource registration (client in sensor/client.py):
`open_source("<host>")` builds a SensorScanSource, with `device` passed
through (CUDA unless named)."""

from ..io.sources import IoType, ScanSourceOptions, register_scan_source


@register_scan_source(IoType.SENSOR)
def _build_sensor_scan_source(source: str, opts: ScanSourceOptions):
    from .scan_source import SensorScanSource

    cfg = opts.take("sensor_config")
    timeout = opts.take("timeout")
    config_timeout = opts.take("config_timeout")
    return SensorScanSource(
        [source],
        lidar_port=opts.take("lidar_port"),
        imu_port=opts.take("imu_port"),
        do_not_reinitialize=bool(opts.take("do_not_reinitialize")),
        no_auto_udp_dest=bool(opts.take("no_auto_udp_dest")),
        # receive timeout default 1.0 s / config handshake 45 s
        # (ref: open_source.h:69-74)
        timeout=timeout if timeout is not None else 1.0,
        config_timeout=(config_timeout if config_timeout is not None
                        else 45.0),
        # None -> reference default 2; 0 propagates and is rejected
        # (no silent coercion of invalid sizes)
        queue_size=(lambda q: 2 if q is None else q)(
            opts.take("queue_size")),
        configs=[cfg] if cfg is not None else None,
        sensor_info=opts.take("sensor_info"),
        soft_id_check=bool(opts.take("soft_id_check")),
        extrinsics=opts.take("extrinsics"),
        extrinsics_file=opts.take("extrinsics_file"),
        error_handler=opts.take("error_handler"),
        device=opts.take("device"),
    )
