"""Sensor namespace mirroring the reference's ``ouster.sdk.sensor``
(ref: python/src/ouster/sdk/sensor/__init__.py)."""

from .http import (  # noqa: F401
    LONG_HTTP_REQUEST_TIMEOUT_SECONDS,
    MIN_VERSION,
    SHORT_HTTP_REQUEST_TIMEOUT_SECONDS,
    SensorHttp,
    SensorHttpError,
    build_sensor_config,
    fetch_metadata,
    get_config,
    set_config,
    set_http_api_headers,
    set_http_api_prefix,
)
from .scan_source import (  # noqa: F401
    ClientError,
    ClientOverflow,
    ClientTimeout,
    Sensor,
    SensorPacketSource,
    SensorScanSource,
)
from .client import (  # noqa: F401
    Client,
    ClientEvent,
    ClientEventType,
    ClientState,
    SensorConnection,
    in_multicast,
    init_client,
)
from .emulator import SensorEmulator  # noqa: F401
from .._deprecation import (  # noqa: F401
    deprecated_alias,
    make_module_getattr,
)

deprecated_alias("min_version", "MIN_VERSION", MIN_VERSION, globals())
__getattr__ = make_module_getattr(globals())
