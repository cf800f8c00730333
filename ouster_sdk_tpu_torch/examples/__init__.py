"""Runnable documentation examples, importable as
``ouster_sdk_tpu_torch.examples.<topic>`` and executable with
``python -m ouster_sdk_tpu_torch.examples.<topic> <args>``
(ref: python/src/ouster/sdk/examples/__init__.py — same layout:
core / pcap / osf / lidar_scan / colormaps / viz / zone_monitor)."""
