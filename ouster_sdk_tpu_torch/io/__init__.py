"""IO namespace: the union of the reference's ``ouster.sdk.pcap``,
``ouster.sdk.osf`` and ``ouster.sdk.bag`` export surfaces
(ref: python/src/ouster/sdk/{pcap,osf,bag}/__init__.py): pcap reading and
writing, the pcap packet and scan sources, OSF reading, writing and file
operations, ROS bags, point-cloud files, the scan-source layer with
open_source, save_scans, the frame staging and the device engine."""

from .pcap import (  # noqa: F401
    PacketInfo,
    PcapDuplicatePortException,
    PcapReader,
    PcapWriter,
    StreamKey,
    StreamStats,
    get_stream_info,
    guess_ports,
    record,
    stream_info,
)
from .pcap_source import (  # noqa: F401
    PcapPacketSource,
    RecordingPacketSource,
    ichunked_before,
    resolve_metadata_paths,
)
from .pcap_scan_source import PcapScanSource  # noqa: F401
from .osf import (  # noqa: F401
    AsyncWriter,
    MessageRef,
    MetadataEntry,
    Encoder,
    LidarScanEncoder,
    OsfScanSource,
    PngLidarScanEncoder,
    Reader,
    Writer,
    ZPngLidarScanEncoder,
)
from .osf_ops import (  # noqa: F401
    backup_osf_file_metablob,
    dump_metadata,
    osf_file_modify_metadata,
    osf_info,
    osf_slice,
    parse_and_print,
    restore_osf_file_metablob,
    slice_and_cast,
)
from .bag import BagPacketSource, BagScanSource  # noqa: F401
from .save import save_scans, scan_to_packets  # noqa: F401
from .cloud_io import read_pointcloud, write_pointcloud  # noqa: F401
from .sources import (  # noqa: F401
    Collator,
    IoType,
    LidarScanSet,
    MultiScanSource,
    OusterIoType,
    PacketSource,
    ScanSource,
    ScanSourceOptions,
    SingleScanSource,
    Slicer,
    SourceURLException,
    collate,
    collate_scans,
    extension_from_io_type,
    io_type,
    io_type_from_extension,
    open_packet_source,
    open_source,
    populate_extrinsics,
)
