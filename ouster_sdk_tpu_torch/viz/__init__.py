"""Visualization namespace mirroring the reference's ``ouster.sdk.viz``
(ref: python/src/ouster/sdk/viz/__init__.py)."""

from .core import (  # noqa: F401
    CLOUD_PALETTE_ORDER,
    COLORMAPS,
    Camera,
    Cloud,
    EventModifierKeys,
    ImuVisualizationConfig,
    LidarScanViz,
    MouseButton,
    MouseButtonEvent,
    PointViz,
    PointVizNotRunningError,
    Selection2d,
    SimpleViz,
    Vec3f,
    Vertex,
    WindowCtx,
    add_default_controls,
    calref_palette,
    colorize,
    grey_palette,
    ls_show,
    magma_palette,
    push_point_viz_handler,
    spezia_palette,
    viridis_palette,
)
from .drawables import (  # noqa: F401
    AxisWithLabel,
    Cuboid,
    Image,
    Label,
    Lines,
    Mesh,
    TargetDisplay,
    render_with_drawables,
)
from .view_mode import (  # noqa: F401
    CloudMode,
    CloudPaletteItem,
    FieldViewMode,
    ImageCloudMode,
    ImageMode,
    NormalsMode,
    RGBMode,
    ReflMode,
    RingMode,
    SimpleMode,
    VizExtraMode,
    is_norm_reflectivity_mode,
)
from .accumulators import (  # noqa: F401
    MapAccumulator,
    ScansAccumulator,
    TracksAccumulator,
)
from .html import export_html  # noqa: F401
from .gl import (  # noqa: F401
    GLContext,
    GLRenderer,
    GLUnavailable,
    gl_available,
    render_offscreen,
    run_window,
)
from .zone_viz import (  # noqa: F401,E402
    precompute_voxel_vertices,
    voxel_style_mesh_from_zone_image_pair,
)
