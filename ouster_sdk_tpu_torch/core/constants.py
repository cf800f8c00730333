"""Channel field names, the range unit and the frame-status bit packing
(ref: ouster_client/include/ouster/chanfield.h:28-103, types.h:40)."""

# Distance of one range bit: packets encode range in millimeters; XYZ output
# is in meters.
RANGE_UNIT = 0.001

# NMEA sentence length in the ACCEL32_GYRO32_NMEA IMU packet block
# (ref: ouster_client/src/parsing.cpp:578-598).
NMEA_SENTENCE_LENGTH = 84


class ChanField:
    """String constants for the channel fields the profile tables and the
    scan-level IMU and zone fields name."""

    RANGE = "RANGE"
    RANGE2 = "RANGE2"
    SIGNAL = "SIGNAL"
    SIGNAL2 = "SIGNAL2"
    REFLECTIVITY = "REFLECTIVITY"
    REFLECTIVITY2 = "REFLECTIVITY2"
    NEAR_IR = "NEAR_IR"
    FLAGS = "FLAGS"
    FLAGS2 = "FLAGS2"
    WINDOW = "WINDOW"
    R = "R"
    G = "G"
    B = "B"
    RGB = "RGB"
    ZONE_MASK = "ZONE_MASK"
    RAW32_WORD1 = "RAW32_WORD1"
    RAW32_WORD2 = "RAW32_WORD2"
    RAW32_WORD3 = "RAW32_WORD3"
    RAW32_WORD4 = "RAW32_WORD4"
    RAW32_WORD5 = "RAW32_WORD5"
    RAW32_WORD6 = "RAW32_WORD6"
    RAW32_WORD7 = "RAW32_WORD7"
    RAW32_WORD8 = "RAW32_WORD8"
    RAW32_WORD9 = "RAW32_WORD9"
    RAW_HEADERS = "RAW_HEADERS"
    NORMALS = "NORMALS"
    NORMALS2 = "NORMALS2"
    IMU_ACC = "IMU_ACC"
    IMU_GYRO = "IMU_GYRO"
    IMU_TIMESTAMP = "IMU_TIMESTAMP"
    IMU_MEASUREMENT_ID = "IMU_MEASUREMENT_ID"
    IMU_STATUS = "IMU_STATUS"
    IMU_PACKET_TIMESTAMP = "IMU_PACKET_TIMESTAMP"
    IMU_ALERT_FLAGS = "IMU_ALERT_FLAGS"
    POSITION_STRING = "POSITION_STRING"
    POSITION_LAT_LONG = "POSITION_LAT_LONG"
    POSITION_TIMESTAMP = "POSITION_TIMESTAMP"
    LIVE_ZONESET_HASH = "LIVE_ZONESET_HASH"
    ZONE_TIMESTAMP = "ZONE_TIMESTAMP"
    ZONE_PACKET_TIMESTAMP = "ZONE_PACKET_TIMESTAMP"
    ZONE_STATES = "ZONE_STATES"
    ZONE_ALERT_FLAGS = "ZONE_ALERT_FLAGS"


# Frame status bit packing (ref: ouster_client/include/ouster/lidar_scan.h
# and lidar_scan.cpp frame_status()).
FRAME_STATUS_THERMAL_SHUTDOWN_SHIFT = 0
FRAME_STATUS_SHOT_LIMITING_SHIFT = 4
