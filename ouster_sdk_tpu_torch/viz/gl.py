"""Hardware-accelerated OpenGL backend for PointViz.

The reference viewer is a GLFW/OpenGL window whose point vertex shader
projects the *range image* to 3D on the GPU: it uploads the range field
plus the XYZ LUT direction/offset tables and per-column poses as a W x 4
texture, and computes ``model * vec4(dir * range + offset, 1)`` per
vertex, discarding range == 0 points by placing them at infinity
(ref: ouster_viz/src/common.h:221-260, point_viz.h:207-296,
ouster_viz/src/cloud.cpp). This module rebuilds that design on a real
OpenGL 3.3+ core context created **without a display** through EGL's
surfaceless platform (Mesa), driven via ctypes — no pip packages — so
true GL rendering works headless wherever Mesa's libEGL is installed
(`gl_available()` says whether it is). When a display and the
pip ``glfw`` package exist, :func:`run_window` drives the same scene
interactively (ref: point_viz.h:207-296 run/run_once + callbacks).

Scene split: point clouds render on the GPU (range+LUT projection,
palette texture, per-column pose texture, z-buffered); thin vector
overlays (Lines/Cuboid/Label/2D panels) composite CPU-side onto the
read-back frame exactly as the software rasterizer draws them — the
reference similarly renders text via a bitmap atlas (gltext.cpp).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import List, Optional, Tuple

import numpy as np

from .core import Camera, Cloud, PointViz, colorize

# ---------------------------------------------------------------------------
# EGL bootstrap (surfaceless platform -> offscreen FBO rendering)
# ---------------------------------------------------------------------------

_EGL_PLATFORM_SURFACELESS_MESA = 0x31DD
_EGL_OPENGL_API = 0x30A2
_EGL_NONE = 0x3038
_EGL_CONTEXT_MAJOR = 0x3098
_EGL_CONTEXT_MINOR = 0x30FB
_EGL_RED = 0x3024
_EGL_GREEN = 0x3023
_EGL_BLUE = 0x3022
_EGL_RENDERABLE_TYPE = 0x3040
_EGL_OPENGL_BIT = 0x0008

# GL enums (core profile subset used below)
GL_COLOR_BUFFER_BIT = 0x4000
GL_DEPTH_BUFFER_BIT = 0x0100
GL_DEPTH_TEST = 0x0B71
GL_BLEND = 0x0BE2
GL_VERTEX_SHADER = 0x8B31
GL_FRAGMENT_SHADER = 0x8B30
GL_COMPILE_STATUS = 0x8B81
GL_LINK_STATUS = 0x8B82
GL_ARRAY_BUFFER = 0x8892
GL_STATIC_DRAW = 0x88E4
GL_FLOAT = 0x1406
GL_POINTS = 0x0000
GL_LINES = 0x0001
GL_TEXTURE_2D = 0x0DE1
GL_TEXTURE0 = 0x84C0
GL_RGBA32F = 0x8814
GL_RGBA = 0x1908
GL_RGB = 0x1907
GL_RGBA8 = 0x8058
GL_UNSIGNED_BYTE = 0x1401
GL_NEAREST = 0x2600
GL_TEXTURE_MIN_FILTER = 0x2801
GL_TEXTURE_MAG_FILTER = 0x2800
GL_TEXTURE_WRAP_S = 0x2802
GL_TEXTURE_WRAP_T = 0x2803
GL_CLAMP_TO_EDGE = 0x812F
GL_FRAMEBUFFER = 0x8D40
GL_RENDERBUFFER = 0x8D41
GL_COLOR_ATTACHMENT0 = 0x8CE0
GL_DEPTH_ATTACHMENT = 0x8D00
GL_FRAMEBUFFER_COMPLETE = 0x8CD5
GL_DEPTH_COMPONENT24 = 0x81A6
GL_PACK_ALIGNMENT = 0x0D05
GL_PROGRAM_POINT_SIZE = 0x8642


class GLUnavailable(RuntimeError):
    """Raised when no usable EGL/OpenGL stack exists on this host."""


def _find_lib(*names: str) -> ctypes.CDLL:
    last: Optional[Exception] = None
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError as e:  # pragma: no cover - depends on host libs
            last = e
    raise GLUnavailable(f"cannot load any of {names}: {last}")


class _GL:
    """ctypes binding over the GL entry points we use, resolved through
    a context-appropriate loader (``eglGetProcAddress`` for EGL
    contexts, ``glfwGetProcAddress`` for GLFW windows — loading EGL
    dispatch stubs for a GLX context would misroute calls) with a
    libGL dlsym fallback."""

    _PROTOS = {
        "glGetString": (ctypes.c_char_p, [ctypes.c_uint]),
        "glGetError": (ctypes.c_uint, []),
        "glEnable": (None, [ctypes.c_uint]),
        "glDisable": (None, [ctypes.c_uint]),
        "glViewport": (None, [ctypes.c_int] * 4),
        "glClearColor": (None, [ctypes.c_float] * 4),
        "glClear": (None, [ctypes.c_uint]),
        "glPointSize": (None, [ctypes.c_float]),
        "glLineWidth": (None, [ctypes.c_float]),
        "glPixelStorei": (None, [ctypes.c_uint, ctypes.c_int]),
        "glReadPixels": (None, [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                                ctypes.c_void_p]),
        "glFinish": (None, []),
        # shaders / programs
        "glCreateShader": (ctypes.c_uint, [ctypes.c_uint]),
        "glShaderSource": (None, [ctypes.c_uint, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_void_p]),
        "glCompileShader": (None, [ctypes.c_uint]),
        "glGetShaderiv": (None, [ctypes.c_uint, ctypes.c_uint,
                                 ctypes.POINTER(ctypes.c_int)]),
        "glGetShaderInfoLog": (None, [ctypes.c_uint, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.c_char_p]),
        "glCreateProgram": (ctypes.c_uint, []),
        "glAttachShader": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glLinkProgram": (None, [ctypes.c_uint]),
        "glGetProgramiv": (None, [ctypes.c_uint, ctypes.c_uint,
                                  ctypes.POINTER(ctypes.c_int)]),
        "glGetProgramInfoLog": (None, [ctypes.c_uint, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.c_char_p]),
        "glUseProgram": (None, [ctypes.c_uint]),
        "glDeleteShader": (None, [ctypes.c_uint]),
        "glGetUniformLocation": (ctypes.c_int, [ctypes.c_uint,
                                                ctypes.c_char_p]),
        "glGetAttribLocation": (ctypes.c_int, [ctypes.c_uint,
                                               ctypes.c_char_p]),
        "glUniform1i": (None, [ctypes.c_int, ctypes.c_int]),
        "glUniform1f": (None, [ctypes.c_int, ctypes.c_float]),
        "glUniformMatrix4fv": (None, [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_ubyte, ctypes.c_void_p]),
        # buffers / VAOs
        "glGenVertexArrays": (None, [ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_uint)]),
        "glBindVertexArray": (None, [ctypes.c_uint]),
        "glGenBuffers": (None, [ctypes.c_int,
                                ctypes.POINTER(ctypes.c_uint)]),
        "glBindBuffer": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glBufferData": (None, [ctypes.c_uint, ctypes.c_ssize_t,
                                ctypes.c_void_p, ctypes.c_uint]),
        "glDeleteBuffers": (None, [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_uint)]),
        "glVertexAttribPointer": (None, [ctypes.c_uint, ctypes.c_int,
                                         ctypes.c_uint, ctypes.c_ubyte,
                                         ctypes.c_int, ctypes.c_void_p]),
        "glEnableVertexAttribArray": (None, [ctypes.c_uint]),
        "glVertexAttrib1f": (None, [ctypes.c_uint, ctypes.c_float]),
        "glVertexAttrib3f": (None, [ctypes.c_uint] + [ctypes.c_float] * 3),
        "glDisableVertexAttribArray": (None, [ctypes.c_uint]),
        "glDrawArrays": (None, [ctypes.c_uint, ctypes.c_int, ctypes.c_int]),
        # textures
        "glGenTextures": (None, [ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_uint)]),
        "glBindTexture": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glActiveTexture": (None, [ctypes.c_uint]),
        "glTexImage2D": (None, [ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_uint, ctypes.c_uint,
                                ctypes.c_void_p]),
        "glTexParameteri": (None, [ctypes.c_uint, ctypes.c_uint,
                                   ctypes.c_int]),
        "glDeleteTextures": (None, [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_uint)]),
        # framebuffers
        "glGenFramebuffers": (None, [ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_uint)]),
        "glBindFramebuffer": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glGenRenderbuffers": (None, [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_uint)]),
        "glBindRenderbuffer": (None, [ctypes.c_uint, ctypes.c_uint]),
        "glRenderbufferStorage": (None, [ctypes.c_uint, ctypes.c_uint,
                                         ctypes.c_int, ctypes.c_int]),
        "glFramebufferRenderbuffer": (None, [ctypes.c_uint, ctypes.c_uint,
                                             ctypes.c_uint, ctypes.c_uint]),
        "glCheckFramebufferStatus": (ctypes.c_uint, [ctypes.c_uint]),
    }

    def __init__(self, loader):
        """`loader(name: str) -> address-or-0` must resolve functions
        for the CURRENT context's API (EGL vs GLX vs WGL)."""
        try:
            libgl: Optional[ctypes.CDLL] = _find_lib(
                "libGL.so.1", "libGL.so", "libOpenGL.so.0")
        except GLUnavailable:
            libgl = None
        for name, (res, args) in self._PROTOS.items():
            try:
                addr = loader(name)
            except Exception:
                addr = None
            if addr:
                fn = ctypes.CFUNCTYPE(res, *args)(addr)
            elif libgl is not None and hasattr(libgl, name):
                fn = getattr(libgl, name)
                fn.restype, fn.argtypes = res, args
            else:
                raise GLUnavailable(f"GL entry point {name} not found")
            setattr(self, name, fn)

    @classmethod
    def from_egl(cls, egl: ctypes.CDLL) -> "_GL":
        egl.eglGetProcAddress.restype = ctypes.c_void_p
        egl.eglGetProcAddress.argtypes = [ctypes.c_char_p]
        return cls(lambda name: egl.eglGetProcAddress(name.encode()))


class GLContext:
    """Offscreen OpenGL 3.3+ core context on EGL's surfaceless platform
    with an RGBA8 + depth24 FBO render target."""

    def __init__(self, width: int, height: int):
        self.width, self.height = int(width), int(height)
        egl = _find_lib("libEGL.so.1", "libEGL.so")
        egl.eglGetPlatformDisplay.restype = ctypes.c_void_p
        egl.eglGetPlatformDisplay.argtypes = [ctypes.c_uint, ctypes.c_void_p,
                                              ctypes.c_void_p]
        egl.eglInitialize.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
        egl.eglChooseConfig.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
        egl.eglCreateContext.restype = ctypes.c_void_p
        egl.eglCreateContext.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p]
        egl.eglMakeCurrent.argtypes = [ctypes.c_void_p] * 4
        egl.eglDestroyContext.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

        dpy = egl.eglGetPlatformDisplay(_EGL_PLATFORM_SURFACELESS_MESA,
                                        None, None)
        if not dpy:
            raise GLUnavailable("no surfaceless EGL display")
        if not egl.eglInitialize(ctypes.c_void_p(dpy), None, None):
            raise GLUnavailable("eglInitialize failed")
        if not egl.eglBindAPI(_EGL_OPENGL_API):
            raise GLUnavailable("eglBindAPI(OPENGL) failed")
        attribs = (ctypes.c_int * 9)(_EGL_RED, 8, _EGL_GREEN, 8, _EGL_BLUE,
                                     8, _EGL_RENDERABLE_TYPE,
                                     _EGL_OPENGL_BIT, _EGL_NONE)
        cfg, n = ctypes.c_void_p(), ctypes.c_int()
        egl.eglChooseConfig(ctypes.c_void_p(dpy), attribs,
                            ctypes.byref(cfg), 1, ctypes.byref(n))
        if n.value < 1:
            # surfaceless Mesa exposes no window configs; rendering
            # targets an FBO anyway, so use EGL_KHR_no_config_context
            cfg = ctypes.c_void_p(None)
        ctx_attribs = (ctypes.c_int * 5)(_EGL_CONTEXT_MAJOR, 3,
                                         _EGL_CONTEXT_MINOR, 3, _EGL_NONE)
        ctx = egl.eglCreateContext(ctypes.c_void_p(dpy), cfg, None,
                                   ctx_attribs)
        if not ctx:
            raise GLUnavailable("eglCreateContext failed")
        self._egl, self._dpy, self._ctx = egl, dpy, ctx
        self.make_current()
        self.gl = _GL.from_egl(egl)
        self._setup_fbo()

    def make_current(self) -> None:
        if not self._egl.eglMakeCurrent(ctypes.c_void_p(self._dpy), None,
                                        None, ctypes.c_void_p(self._ctx)):
            raise GLUnavailable("eglMakeCurrent failed")

    def _setup_fbo(self) -> None:
        gl = self.gl
        fbo, rb_c, rb_d = (ctypes.c_uint(), ctypes.c_uint(),
                           ctypes.c_uint())
        gl.glGenFramebuffers(1, ctypes.byref(fbo))
        gl.glBindFramebuffer(GL_FRAMEBUFFER, fbo.value)
        gl.glGenRenderbuffers(1, ctypes.byref(rb_c))
        gl.glBindRenderbuffer(GL_RENDERBUFFER, rb_c.value)
        gl.glRenderbufferStorage(GL_RENDERBUFFER, GL_RGBA8, self.width,
                                 self.height)
        gl.glFramebufferRenderbuffer(GL_FRAMEBUFFER, GL_COLOR_ATTACHMENT0,
                                     GL_RENDERBUFFER, rb_c.value)
        gl.glGenRenderbuffers(1, ctypes.byref(rb_d))
        gl.glBindRenderbuffer(GL_RENDERBUFFER, rb_d.value)
        gl.glRenderbufferStorage(GL_RENDERBUFFER, GL_DEPTH_COMPONENT24,
                                 self.width, self.height)
        gl.glFramebufferRenderbuffer(GL_FRAMEBUFFER, GL_DEPTH_ATTACHMENT,
                                     GL_RENDERBUFFER, rb_d.value)
        status = gl.glCheckFramebufferStatus(GL_FRAMEBUFFER)
        if status != GL_FRAMEBUFFER_COMPLETE:
            raise GLUnavailable(f"FBO incomplete: {status:#x}")
        gl.glViewport(0, 0, self.width, self.height)

    def read(self) -> np.ndarray:
        """Read back the FBO as (H, W, 3) u8, top row first."""
        gl = self.gl
        buf = np.empty((self.height, self.width, 4), dtype=np.uint8)
        gl.glPixelStorei(GL_PACK_ALIGNMENT, 1)
        gl.glFinish()
        gl.glReadPixels(0, 0, self.width, self.height, GL_RGBA,
                        GL_UNSIGNED_BYTE,
                        buf.ctypes.data_as(ctypes.c_void_p))
        return buf[::-1, :, :3].copy()  # GL rows are bottom-up

    def close(self) -> None:
        if getattr(self, "_ctx", None):
            self._egl.eglMakeCurrent(ctypes.c_void_p(self._dpy), None,
                                     None, None)
            self._egl.eglDestroyContext(ctypes.c_void_p(self._dpy),
                                        ctypes.c_void_p(self._ctx))
            self._ctx = None


# ---------------------------------------------------------------------------
# Shaders — our expression of the reference's range+LUT GPU projection
# (ref: ouster_viz/src/common.h:221-260)
# ---------------------------------------------------------------------------

_POINT_VS = b"""
#version 330 core
in vec3 dir;        // XYZ LUT direction (range unit folded in)
in vec3 off;        // XYZ LUT offset, metres
in float range;     // raw range counts; <= 0 -> discarded
in float key;       // palette coordinate in [0, 1]
in float col_frac;  // column index / (W-1), selects the pose column
uniform mat4 model;      // per-cloud pose
uniform mat4 proj_view;  // camera
uniform sampler2D pose_tex;  // W x 4: per-column 4x4 poses by columns
out float v_key;
void main() {
    v_key = key;
    if (range <= 0.0) {
        gl_Position = vec4(2e30, 2e30, 2e30, 1.0);  // off-frustum cull
        return;
    }
    vec4 local = model * vec4(dir * range + off, 1.0);
    int w = textureSize(pose_tex, 0).x;
    int c = clamp(int(round(col_frac * float(w - 1))), 0, w - 1);
    vec4 r0 = texelFetch(pose_tex, ivec2(c, 0), 0);
    vec4 r1 = texelFetch(pose_tex, ivec2(c, 1), 0);
    vec4 r2 = texelFetch(pose_tex, ivec2(c, 2), 0);
    vec4 t  = texelFetch(pose_tex, ivec2(c, 3), 0);
    mat4 col_pose = mat4(r0.x, r0.y, r0.z, 0.0,
                         r1.x, r1.y, r1.z, 0.0,
                         r2.x, r2.y, r2.z, 0.0,
                          t.x,  t.y,  t.z, 1.0);
    gl_Position = proj_view * col_pose * local;
}
"""

_POINT_FS = b"""
#version 330 core
in float v_key;
uniform sampler2D palette;
out vec4 color;
void main() {
    color = vec4(texture(palette, vec2(v_key, 0.5)).rgb, 1.0);
}
"""

_LINE_VS = b"""
#version 330 core
in vec3 pos;
in vec3 rgb;
uniform mat4 proj_view;
out vec3 v_rgb;
void main() { v_rgb = rgb; gl_Position = proj_view * vec4(pos, 1.0); }
"""

_LINE_FS = b"""
#version 330 core
in vec3 v_rgb;
out vec4 color;
void main() { color = vec4(v_rgb, 1.0); }
"""


def _compile(gl: _GL, vs_src: bytes, fs_src: bytes) -> int:
    def shader(kind: int, src: bytes) -> int:
        s = gl.glCreateShader(kind)
        arr = (ctypes.c_char_p * 1)(src)
        gl.glShaderSource(s, 1, arr, None)
        gl.glCompileShader(s)
        ok = ctypes.c_int()
        gl.glGetShaderiv(s, GL_COMPILE_STATUS, ctypes.byref(ok))
        if not ok.value:
            log = ctypes.create_string_buffer(4096)
            gl.glGetShaderInfoLog(s, 4096, None, log)
            raise GLUnavailable(f"shader compile: {log.value.decode()}")
        return s

    prog = gl.glCreateProgram()
    v, f = shader(GL_VERTEX_SHADER, vs_src), shader(GL_FRAGMENT_SHADER,
                                                    fs_src)
    gl.glAttachShader(prog, v)
    gl.glAttachShader(prog, f)
    gl.glLinkProgram(prog)
    ok = ctypes.c_int()
    gl.glGetProgramiv(prog, GL_LINK_STATUS, ctypes.byref(ok))
    if not ok.value:
        log = ctypes.create_string_buffer(4096)
        gl.glGetProgramInfoLog(prog, 4096, None, log)
        raise GLUnavailable(f"link: {log.value.decode()}")
    gl.glDeleteShader(v)
    gl.glDeleteShader(f)
    return prog


def _perspective(cam: Camera, width: int, height: int,
                 near: float = 0.1, far: float = 4000.0) -> np.ndarray:
    """Projection matching the software rasterizer's pinhole model
    (viz/core.py render: f = H/2 / tan(fov/2))."""
    f = 1.0 / math.tan(math.radians(cam.fov) / 2)
    aspect = width / height
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = f / aspect
    P[1, 1] = f
    P[2, 2] = (far + near) / (near - far)
    P[2, 3] = 2 * far * near / (near - far)
    P[3, 2] = -1.0
    return P


def _upload_mat4(gl: _GL, loc: int, M: np.ndarray) -> None:
    m = np.ascontiguousarray(M, dtype=np.float32)
    gl.glUniformMatrix4fv(loc, 1, 1, m.ctypes.data_as(ctypes.c_void_p))


class _CloudBuffers:
    """GPU-side buffers for one cloud (VBOs + palette/pose textures)."""

    def __init__(self, gl: _GL, cloud: Cloud):
        self.gl = gl
        self.point_size = float(getattr(cloud, "point_size", 1) or 1)
        gl_model = getattr(cloud, "gl_model", None)
        self.model = (gl_model if gl_model is not None
                      else getattr(cloud, "pose", np.eye(4)))

        rng_img = getattr(cloud, "range_image", None)
        if rng_img is not None:
            # reference GPU path: upload range + LUT, project in-shader
            h, w = rng_img.shape
            dirs = np.ascontiguousarray(
                cloud.lut_dir.reshape(-1, 3), dtype=np.float32)
            offs = np.ascontiguousarray(
                cloud.lut_offset.reshape(-1, 3), dtype=np.float32)
            rng = np.ascontiguousarray(rng_img.reshape(-1),
                                       dtype=np.float32)
            col = np.tile(
                (np.arange(w, dtype=np.float32) / max(w - 1, 1)), h)
            poses = getattr(cloud, "column_poses", None)
            self.n = h * w
        else:
            xyz = np.ascontiguousarray(cloud.xyz.reshape(-1, 3),
                                       dtype=np.float32)
            dirs, offs = xyz, np.zeros_like(xyz)
            rng = np.ones(len(xyz), dtype=np.float32)
            # direct-xyz clouds may still carry all-zero rows for
            # invalid pixels; cull them like the reference's range==0
            rng[~np.any(xyz != 0.0, axis=1)] = 0.0
            col = np.zeros(len(xyz), dtype=np.float32)
            poses = None
            self.n = len(xyz)

        key = getattr(cloud, "key", None)
        keyv = (np.ones(self.n, dtype=np.float32) if key is None
                else np.clip(np.asarray(key, dtype=np.float32
                                        ).reshape(-1), 0.0, 1.0))
        if key is None:
            pal_rgb = np.full((256, 3), 200, dtype=np.uint8)  # flat grey
        else:
            ramp = np.linspace(0.0, 1.0, 256, dtype=np.float32)
            pal = getattr(cloud, "palette", "viridis")
            if isinstance(pal, np.ndarray):
                idx = np.clip((ramp * (len(pal) - 1)).astype(int), 0,
                              len(pal) - 1)
                pal_rgb = (pal[idx] * 255).astype(np.uint8)
            else:
                pal_rgb = colorize(ramp, pal or "viridis")

        self.vbos = (ctypes.c_uint * 5)()
        gl.glGenBuffers(5, self.vbos)
        for vbo, arr in zip(self.vbos, (dirs, offs, rng, keyv, col)):
            a = np.ascontiguousarray(arr, dtype=np.float32)
            gl.glBindBuffer(GL_ARRAY_BUFFER, vbo)
            gl.glBufferData(GL_ARRAY_BUFFER, a.nbytes,
                            a.ctypes.data_as(ctypes.c_void_p),
                            GL_STATIC_DRAW)

        # palette: 256 x 1 RGB texture
        self.tex = (ctypes.c_uint * 2)()
        gl.glGenTextures(2, self.tex)
        gl.glBindTexture(GL_TEXTURE_2D, self.tex[0])
        for p in (GL_TEXTURE_MIN_FILTER, GL_TEXTURE_MAG_FILTER):
            gl.glTexParameteri(GL_TEXTURE_2D, p, GL_NEAREST)
        for p in (GL_TEXTURE_WRAP_S, GL_TEXTURE_WRAP_T):
            gl.glTexParameteri(GL_TEXTURE_2D, p, GL_CLAMP_TO_EDGE)
        pal_rgba = np.ascontiguousarray(
            np.concatenate([pal_rgb,
                            np.full((256, 1), 255, np.uint8)], axis=1))
        gl.glTexImage2D(GL_TEXTURE_2D, 0, GL_RGBA8, 256, 1, 0, GL_RGBA,
                        GL_UNSIGNED_BYTE,
                        pal_rgba.ctypes.data_as(ctypes.c_void_p))

        # per-column pose texture, reference W x 4 layout
        # (common.h:254-260): row r holds column r of each 4x4 matrix
        if poses is None:
            poses = np.eye(4)[None]
        poses = np.asarray(poses, dtype=np.float32).reshape(-1, 4, 4)
        w = len(poses)
        texdata = np.zeros((4, w, 4), dtype=np.float32)
        for r in range(4):
            texdata[r, :, :] = poses[:, :, r]  # matrix column r -> texel
        texdata = np.ascontiguousarray(texdata)
        gl.glBindTexture(GL_TEXTURE_2D, self.tex[1])
        for p in (GL_TEXTURE_MIN_FILTER, GL_TEXTURE_MAG_FILTER):
            gl.glTexParameteri(GL_TEXTURE_2D, p, GL_NEAREST)
        for p in (GL_TEXTURE_WRAP_S, GL_TEXTURE_WRAP_T):
            gl.glTexParameteri(GL_TEXTURE_2D, p, GL_CLAMP_TO_EDGE)
        gl.glTexImage2D(GL_TEXTURE_2D, 0, GL_RGBA32F, w, 4, 0, GL_RGBA,
                        GL_FLOAT, texdata.ctypes.data_as(ctypes.c_void_p))

    def release(self) -> None:
        self.gl.glDeleteBuffers(5, self.vbos)
        self.gl.glDeleteTextures(2, self.tex)


class GLRenderer:
    """Renders a :class:`PointViz` scene on a real GL context.

    Offscreen by default (surfaceless EGL + FBO readback); the same
    draw path serves :func:`run_window` when a window system exists.
    """

    def __init__(self, width: int = 1024, height: int = 768,
                 context: Optional[GLContext] = None):
        self.ctx = context or GLContext(width, height)
        gl = self.ctx.gl
        self.point_prog = _compile(gl, _POINT_VS, _POINT_FS)
        self.line_prog = _compile(gl, _LINE_VS, _LINE_FS)
        vao = ctypes.c_uint()
        gl.glGenVertexArrays(1, ctypes.byref(vao))
        gl.glBindVertexArray(vao.value)
        self._attr = {
            n: gl.glGetAttribLocation(self.point_prog, n.encode())
            for n in ("dir", "off", "range", "key", "col_frac")}
        self._uni = {
            n: gl.glGetUniformLocation(self.point_prog, n.encode())
            for n in ("model", "proj_view", "pose_tex", "palette")}
        self._lattr = {
            n: gl.glGetAttribLocation(self.line_prog, n.encode())
            for n in ("pos", "rgb")}
        self._lpv = gl.glGetUniformLocation(self.line_prog,
                                            b"proj_view")
        # (id(cloud), cloud, buffers): buffers are uploaded once per
        # cloud object and reused across frames (interactive loop); the
        # strong cloud ref pins the id against reuse until eviction
        self._cloud_cache: List[Tuple[int, object, _CloudBuffers]] = []

    def proj_view(self, viz: PointViz) -> np.ndarray:
        return _perspective(viz.camera, self.ctx.width,
                            self.ctx.height) @ viz.camera.view_matrix()

    def draw(self, viz: PointViz) -> None:
        """Issue GL draw calls for the scene's clouds (no readback)."""
        gl = self.ctx.gl
        self.ctx.make_current()
        gl.glViewport(0, 0, self.ctx.width, self.ctx.height)
        gl.glEnable(GL_DEPTH_TEST)
        gl.glClearColor(0.0, 0.0, 0.0, 1.0)
        gl.glClear(GL_COLOR_BUFFER_BIT | GL_DEPTH_BUFFER_BIT)

        PV = self.proj_view(viz)
        gl.glUseProgram(self.point_prog)
        _upload_mat4(gl, self._uni["proj_view"], PV)
        gl.glUniform1i(self._uni["pose_tex"], 1)
        gl.glUniform1i(self._uni["palette"], 0)

        # refresh the buffer cache: upload new clouds, evict removed
        # ones (clouds are immutable once added; scene updates swap in
        # new Cloud objects)
        live = {id(c) for c in viz._clouds}
        kept = []
        for cid, cloud, bufs in self._cloud_cache:
            if cid in live:
                kept.append((cid, cloud, bufs))
            else:
                bufs.release()
        self._cloud_cache = kept
        cached = {cid: bufs for cid, _, bufs in self._cloud_cache}

        sizes = {"dir": 3, "off": 3, "range": 1, "key": 1,
                 "col_frac": 1}
        for cloud in viz._clouds:
            bufs = cached.get(id(cloud))
            if bufs is None:
                bufs = _CloudBuffers(gl, cloud)
                self._cloud_cache.append((id(cloud), cloud, bufs))
            _upload_mat4(gl, self._uni["model"], bufs.model)
            gl.glPointSize(bufs.point_size)
            for vbo, name in zip(bufs.vbos,
                                 ("dir", "off", "range", "key",
                                  "col_frac")):
                loc = self._attr[name]
                if loc < 0:
                    continue
                gl.glBindBuffer(GL_ARRAY_BUFFER, vbo)
                gl.glEnableVertexAttribArray(loc)
                gl.glVertexAttribPointer(loc, sizes[name], GL_FLOAT, 0,
                                         0, None)
            gl.glActiveTexture(GL_TEXTURE0)
            gl.glBindTexture(GL_TEXTURE_2D, bufs.tex[0])
            gl.glActiveTexture(GL_TEXTURE0 + 1)
            gl.glBindTexture(GL_TEXTURE_2D, bufs.tex[1])
            gl.glDrawArrays(GL_POINTS, 0, bufs.n)
        # leave no point-program attrib arrays enabled: the line pass
        # binds only its own two, and a 3.3 core draw with an enabled
        # array whose buffer was deleted is GL_INVALID_OPERATION
        for name in sizes:
            if self._attr[name] >= 0:
                gl.glDisableVertexAttribArray(self._attr[name])

        # GL line pass for segment-bearing drawables (Lines and friends
        # expose `segments`; Cuboid/Mesh composite via the CPU overlay)
        segs: List[np.ndarray] = []
        cols: List[np.ndarray] = []
        for d in viz._drawables:
            s = getattr(d, "segments", None)
            if s is None:
                continue
            s = np.asarray(s, dtype=np.float32).reshape(-1, 2, 3)
            segs.append(s)
            c = np.asarray(getattr(d, "color", (255, 255, 255)),
                           dtype=np.float32) / 255.0
            cols.append(np.broadcast_to(c, (s.shape[0] * 2, 3)))
        if segs:
            pts = np.ascontiguousarray(np.concatenate(segs).reshape(-1, 3))
            rgb = np.ascontiguousarray(np.concatenate(cols))
            gl.glUseProgram(self.line_prog)
            _upload_mat4(gl, self._lpv, PV)
            # overlay semantics like the software backend's Lines.draw
            # (writes over the frame, ignoring the z-buffer)
            gl.glDisable(GL_DEPTH_TEST)
            vbos = (ctypes.c_uint * 2)()
            gl.glGenBuffers(2, vbos)
            for vbo, arr, loc, sz in ((vbos[0], pts, self._lattr["pos"], 3),
                                      (vbos[1], rgb, self._lattr["rgb"],
                                       3)):
                gl.glBindBuffer(GL_ARRAY_BUFFER, vbo)
                gl.glBufferData(GL_ARRAY_BUFFER, arr.nbytes,
                                arr.ctypes.data_as(ctypes.c_void_p),
                                GL_STATIC_DRAW)
                gl.glEnableVertexAttribArray(loc)
                gl.glVertexAttribPointer(loc, sz, GL_FLOAT, 0, 0, None)
            gl.glDrawArrays(GL_LINES, 0, len(pts))
            for loc in self._lattr.values():
                if loc >= 0:
                    gl.glDisableVertexAttribArray(loc)
            gl.glDeleteBuffers(2, vbos)
            gl.glEnable(GL_DEPTH_TEST)

    def render(self, viz: PointViz) -> np.ndarray:
        """Full frame: GPU clouds + GL lines, then CPU compositing of
        the remaining 2D overlays (labels, image panels) — mirroring the
        software path so both backends agree pixel-for-pixel on
        overlays."""
        self.draw(viz)
        frame = self.ctx.read()
        for d in viz._drawables:
            if getattr(d, "segments", None) is not None:
                continue  # already drawn as GL lines
            d.draw(viz, frame)
        y_off = 0
        H, W = frame.shape[:2]
        for rgb, _, _ in viz._images:
            ph, pw = rgb.shape[:2]
            target_h = max(int(ph * (W / pw)) // 2, 1)
            ys = np.linspace(0, ph - 1, target_h).astype(int)
            xs = np.linspace(0, pw - 1, W).astype(int)
            if y_off + target_h <= H:
                frame[y_off:y_off + target_h] = rgb[ys][:, xs]
                y_off += target_h
        for h in viz._fb_handlers:
            h(frame, W, H)
        return frame

    def close(self) -> None:
        for _, _, bufs in self._cloud_cache:
            try:
                bufs.release()
            except Exception:
                pass  # context may already be gone
        self._cloud_cache = []
        self.ctx.close()


def render_offscreen(viz: PointViz,
                     renderer: Optional[GLRenderer] = None) -> np.ndarray:
    """One-shot GL render of a PointViz scene; raises
    :class:`GLUnavailable` when the host has no EGL/GL stack."""
    own = renderer is None
    r = renderer or GLRenderer(viz.width, viz.height)
    try:
        return r.render(viz)
    finally:
        if own:
            r.close()


def gl_available() -> bool:
    """True when a surfaceless EGL + GL 3.3 context can be created."""
    try:
        ctx = GLContext(4, 4)
    except Exception:
        return False
    ctx.close()
    return True


# ---------------------------------------------------------------------------
# Interactive window (import-gated on pip `glfw`)
# ---------------------------------------------------------------------------

class WindowEventBridge:
    """The window's event wiring, factored out of :func:`run_window` so
    the full interactive scene graph — orbit/dolly camera mutation plus
    event-registry dispatch — is drivable without a display (ref:
    point_viz.cpp GLFW callbacks; point_viz.h:~600-745 handler stacks).

    ``press`` is the toolkit's PRESS action constant and ``cursor_pos``
    maps a window handle to the pointer position (``glfw.get_cursor_pos``
    under a real window; any stub in headless tests). The methods have
    exact GLFW callback signatures so :func:`run_window` installs them
    unwrapped."""

    def __init__(self, viz: PointViz, press, cursor_pos,
                 orbit_gain: float = 0.3):
        self.viz = viz
        self._press = press
        self._cursor_pos = cursor_pos
        self._gain = orbit_gain
        self.drag = {"on": False, "x": 0.0, "y": 0.0}

    def on_mouse(self, win, button, action, mods) -> None:
        self.drag["on"] = action == self._press
        self.drag["x"], self.drag["y"] = self._cursor_pos(win)
        self.viz.dispatch_mouse_button(button, action, mods)

    def on_move(self, win, x, y) -> None:
        if self.drag["on"]:
            self.viz.camera.orbit((x - self.drag["x"]) * self._gain,
                                  -(y - self.drag["y"]) * self._gain)
            self.drag["x"], self.drag["y"] = x, y

    def on_scroll(self, win, dx, dy) -> None:
        self.viz.camera.dolly(dy)
        self.viz.dispatch_scroll(dx, dy)

    def on_key(self, win, key, scancode, action, mods) -> None:
        if action == self._press:
            self.viz.dispatch_key(key, mods)


def run_window(viz: PointViz, scan_iter=None, title: str = "ouster-viz",
               fps: float = 60.0) -> None:
    """Interactive GLFW window over the same GL scene — the reference's
    `PointViz::run()` loop (ref: point_viz.h:207-296): orbit on drag,
    dolly on scroll, key events through ``viz.dispatch_key``. Requires
    the pip ``glfw`` package and a display; headless hosts should use
    :func:`render_offscreen` or the HTML export instead."""
    try:
        import glfw  # type: ignore
    except ImportError as e:
        raise GLUnavailable(
            "interactive window needs the pip 'glfw' package and a "
            "display; use render_offscreen()/SimpleViz snapshots or "
            "`viz --html` on headless hosts") from e
    if not glfw.init():
        raise GLUnavailable("glfw.init failed (no display?)")
    try:
        glfw.window_hint(glfw.CONTEXT_VERSION_MAJOR, 3)
        glfw.window_hint(glfw.CONTEXT_VERSION_MINOR, 3)
        glfw.window_hint(glfw.OPENGL_PROFILE, glfw.OPENGL_CORE_PROFILE)
        win = glfw.create_window(viz.width, viz.height, title, None, None)
        if not win:
            raise GLUnavailable("glfw window creation failed")
        glfw.make_context_current(win)

        class _WindowCtx:
            """Context adapter: GLRenderer only needs .gl, dimensions,
            and make_current(); drawing targets the default
            framebuffer glfw owns."""

            def __init__(self_inner):
                self_inner.width, self_inner.height = (viz.width,
                                                       viz.height)
                # glfwGetProcAddress resolves for the window's actual
                # context API (GLX on X11/NVIDIA, EGL on Wayland, WGL
                # on Windows) — never mix EGL stubs into a GLX context
                self_inner.gl = _GL(glfw.get_proc_address)

            def make_current(self_inner) -> None:
                glfw.make_context_current(win)

            def close(self_inner) -> None:
                pass

        renderer = GLRenderer(context=_WindowCtx())  # type: ignore

        bridge = WindowEventBridge(viz, glfw.PRESS, glfw.get_cursor_pos)
        glfw.set_mouse_button_callback(win, bridge.on_mouse)
        glfw.set_cursor_pos_callback(win, bridge.on_move)
        glfw.set_scroll_callback(win, bridge.on_scroll)
        glfw.set_key_callback(win, bridge.on_key)

        it = iter(scan_iter) if scan_iter is not None else None
        while not glfw.window_should_close(win):
            if it is not None:
                try:
                    next(it)
                except StopIteration:
                    it = None
            renderer.draw(viz)
            glfw.swap_buffers(win)
            glfw.poll_events()
    finally:
        glfw.terminate()
