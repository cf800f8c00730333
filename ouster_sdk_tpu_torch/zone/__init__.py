"""Zone-monitoring namespace mirroring the reference's
``ouster.sdk.zone_monitor``
(ref: python/src/ouster/sdk/zone_monitor/__init__.py). Like the JAX
package, the top level does not re-export it: import
``ouster_sdk_tpu_torch.zone``."""

from .zrb import Zrb  # noqa: F401
from .zone import (  # noqa: F401
    BeamConfig,
    Coord,
    CoordinateFrame,
    Mesh,
    Triangle,
    Stl,
    Zone,
    ZoneError,
    ZoneMode,
    ZoneSet,
    ZoneSetOutputFilter,
    load_stl,
    save_stl,
)
from .monitor import (  # noqa: F401
    MAX_ACTIVE_ZONES,
    MAX_AVAILABLE_ZONES,
    EmulatedZoneMon,
    ZoneMonitor,
    ZoneState,
    render_zone_bounds,
    zone_occupancy,
    zone_occupancy_device,
)

#: LidarScan field names carrying zone-monitor data
#: (ref: python/src/ouster/sdk/zone_monitor/__init__.py:11-12)
ZONE_STATES_FIELDNAME = "ZONE_STATES"
ZONE_OCCUPANCY_FIELDNAME = "ZONE_MASK"
