"""JPEG XL codec via ctypes over the system ``libjxl`` (counterpart of
``aliby_tpu/io/jxl.py``).

``decode(buf)`` / ``encode(arr)`` have the contract the zarr chunk path
needs: a raw JXL codestream or container in, a 2-D (or 2-D + channel) numpy
array out, gray or RGB, uint8/uint16/float32. No Python package is needed;
where the library is absent, :func:`available` is False and the zarr layer
tries ``imagecodecs``.

ABI: libjxl 0.7 (Debian ``libjxl0.7``). The struct layouts below mirror
``jxl/codestream_header.h`` / ``jxl/types.h`` / ``jxl/color_encoding.h``
at that version, byte for byte; ``JxlEncoderInitBasicInfo`` fills encoder
defaults so only the fields set here are version-sensitive.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np

# ---------------------------------------------------------------------------
# library + ABI
# ---------------------------------------------------------------------------

_JXL_NAMES = ("libjxl.so.0.7", "libjxl.so.0.8", "libjxl.so", "jxl")


@lru_cache(maxsize=1)
def _lib():
    last = None
    for name in _JXL_NAMES:
        try:
            return ctypes.CDLL(name)
        except OSError as e:  # try the linker's idea of the name too
            last = e
    path = ctypes.util.find_library("jxl")
    if path:
        return ctypes.CDLL(path)
    raise ImportError(f"libjxl shared library not found: {last}")


def available() -> bool:
    try:
        _lib()
        return True
    except ImportError:
        return False


# JxlDataType (jxl/types.h @0.7)
_TYPE_FLOAT = 0
_TYPE_UINT8 = 2
_TYPE_UINT16 = 3
_TYPE_FLOAT16 = 5

# JxlDecoderStatus
_DEC_SUCCESS = 0
_DEC_ERROR = 1
_DEC_NEED_MORE_INPUT = 2
_DEC_NEED_IMAGE_OUT_BUFFER = 5
_DEC_BASIC_INFO = 0x40
_DEC_FULL_IMAGE = 0x1000

# JxlEncoderStatus
_ENC_SUCCESS = 0
_ENC_ERROR = 1
_ENC_NEED_MORE_OUTPUT = 2


class _PixelFormat(ctypes.Structure):
    _fields_ = [
        ("num_channels", ctypes.c_uint32),
        ("data_type", ctypes.c_int),
        ("endianness", ctypes.c_int),  # JXL_NATIVE_ENDIAN = 0
        ("align", ctypes.c_size_t),
    ]


class _PreviewHeader(ctypes.Structure):
    _fields_ = [("xsize", ctypes.c_uint32), ("ysize", ctypes.c_uint32)]


class _AnimationHeader(ctypes.Structure):
    _fields_ = [
        ("tps_numerator", ctypes.c_uint32),
        ("tps_denominator", ctypes.c_uint32),
        ("num_loops", ctypes.c_uint32),
        ("have_timecodes", ctypes.c_int32),
    ]


class _BasicInfo(ctypes.Structure):
    # jxl/codestream_header.h @0.7 (JXL_BOOL == int32)
    _fields_ = [
        ("have_container", ctypes.c_int32),
        ("xsize", ctypes.c_uint32),
        ("ysize", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("exponent_bits_per_sample", ctypes.c_uint32),
        ("intensity_target", ctypes.c_float),
        ("min_nits", ctypes.c_float),
        ("relative_to_max_display", ctypes.c_int32),
        ("linear_below", ctypes.c_float),
        ("uses_original_profile", ctypes.c_int32),
        ("have_preview", ctypes.c_int32),
        ("have_animation", ctypes.c_int32),
        ("orientation", ctypes.c_int),
        ("num_color_channels", ctypes.c_uint32),
        ("num_extra_channels", ctypes.c_uint32),
        ("alpha_bits", ctypes.c_uint32),
        ("alpha_exponent_bits", ctypes.c_uint32),
        ("alpha_premultiplied", ctypes.c_int32),
        ("preview", _PreviewHeader),
        ("animation", _AnimationHeader),
        ("intrinsic_xsize", ctypes.c_uint32),
        ("intrinsic_ysize", ctypes.c_uint32),
        ("padding", ctypes.c_uint8 * 100),
    ]


class _ColorEncoding(ctypes.Structure):
    # jxl/color_encoding.h @0.7
    _fields_ = [
        ("color_space", ctypes.c_int),
        ("white_point", ctypes.c_int),
        ("white_point_xy", ctypes.c_double * 2),
        ("primaries", ctypes.c_int),
        ("primaries_red_xy", ctypes.c_double * 2),
        ("primaries_green_xy", ctypes.c_double * 2),
        ("primaries_blue_xy", ctypes.c_double * 2),
        ("transfer_function", ctypes.c_int),
        ("gamma", ctypes.c_double),
        ("rendering_intent", ctypes.c_int),
    ]


def _dtype_to_jxl(dt: np.dtype) -> tuple[int, int, int]:
    """numpy dtype -> (JxlDataType, bits_per_sample, exponent_bits)."""
    dt = np.dtype(dt)
    if dt == np.uint8:
        return _TYPE_UINT8, 8, 0
    if dt == np.uint16:
        return _TYPE_UINT16, 16, 0
    if dt == np.float32:
        return _TYPE_FLOAT, 32, 8
    if dt == np.float16:
        return _TYPE_FLOAT16, 16, 5
    raise ValueError(f"JXL codec: unsupported dtype {dt}")


def _jxl_to_dtype(info: _BasicInfo) -> tuple[np.dtype, int]:
    if info.exponent_bits_per_sample:
        return (
            np.dtype(np.float32)
            if info.bits_per_sample > 16
            else np.dtype(np.float16)
        ), (_TYPE_FLOAT if info.bits_per_sample > 16 else _TYPE_FLOAT16)
    if info.bits_per_sample <= 8:
        return np.dtype(np.uint8), _TYPE_UINT8
    return np.dtype(np.uint16), _TYPE_UINT16


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode(buf: bytes) -> np.ndarray:
    """JXL codestream/container bytes -> (H, W) or (H, W, C) array."""
    lib = _lib()
    lib.JxlDecoderCreate.restype = ctypes.c_void_p
    dec = lib.JxlDecoderCreate(None)
    if not dec:
        raise RuntimeError("JxlDecoderCreate failed")
    try:
        if lib.JxlDecoderSubscribeEvents(
            ctypes.c_void_p(dec), _DEC_BASIC_INFO | _DEC_FULL_IMAGE
        ):
            raise RuntimeError("JxlDecoderSubscribeEvents failed")
        data = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
        if lib.JxlDecoderSetInput(
            ctypes.c_void_p(dec), data, ctypes.c_size_t(len(buf))
        ):
            raise RuntimeError("JxlDecoderSetInput failed")
        lib.JxlDecoderCloseInput(ctypes.c_void_p(dec))

        info = _BasicInfo()
        out = None
        fmt = None
        while True:
            status = lib.JxlDecoderProcessInput(ctypes.c_void_p(dec))
            if status == _DEC_BASIC_INFO:
                if lib.JxlDecoderGetBasicInfo(
                    ctypes.c_void_p(dec), ctypes.byref(info)
                ):
                    raise RuntimeError("JxlDecoderGetBasicInfo failed")
            elif status == _DEC_NEED_IMAGE_OUT_BUFFER:
                dtype, jxl_type = _jxl_to_dtype(info)
                nchan = info.num_color_channels + (
                    1 if info.alpha_bits else 0
                )
                fmt = _PixelFormat(
                    num_channels=nchan,
                    data_type=jxl_type,
                    endianness=0,
                    align=0,
                )
                need = ctypes.c_size_t()
                if lib.JxlDecoderImageOutBufferSize(
                    ctypes.c_void_p(dec), ctypes.byref(fmt), ctypes.byref(need)
                ):
                    raise RuntimeError("JxlDecoderImageOutBufferSize failed")
                shape = (
                    (info.ysize, info.xsize)
                    if nchan == 1
                    else (info.ysize, info.xsize, nchan)
                )
                out = np.empty(shape, dtype)
                assert out.nbytes == need.value, (out.nbytes, need.value)
                if lib.JxlDecoderSetImageOutBuffer(
                    ctypes.c_void_p(dec),
                    ctypes.byref(fmt),
                    out.ctypes.data_as(ctypes.c_void_p),
                    ctypes.c_size_t(out.nbytes),
                ):
                    raise RuntimeError("JxlDecoderSetImageOutBuffer failed")
            elif status == _DEC_FULL_IMAGE:
                pass  # frame decoded into `out`
            elif status == _DEC_SUCCESS:
                if out is None:
                    raise ValueError("JXL stream held no image")
                return out
            elif status == _DEC_NEED_MORE_INPUT:
                raise ValueError("truncated JXL stream")
            else:
                raise RuntimeError(f"JXL decode error (status {status})")
    finally:
        lib.JxlDecoderDestroy(ctypes.c_void_p(dec))


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def encode(arr: np.ndarray, lossless: bool = True, effort: int = 3) -> bytes:
    """(H, W) or (H, W, C<=4) array -> JXL codestream bytes.

    Defaults to lossless (microscopy fixtures must round-trip exactly);
    ``effort`` 1-9 trades encode time for density (3 ~ squirrel-lite).
    """
    arr = np.ascontiguousarray(arr)
    if arr.ndim == 2:
        h, w, nchan = arr.shape[0], arr.shape[1], 1
    elif arr.ndim == 3 and arr.shape[2] in (1, 2, 3, 4):
        h, w, nchan = arr.shape
    else:
        raise ValueError(f"JXL codec: bad shape {arr.shape}")
    jxl_type, bits, ebits = _dtype_to_jxl(arr.dtype)

    lib = _lib()
    lib.JxlEncoderCreate.restype = ctypes.c_void_p
    lib.JxlEncoderFrameSettingsCreate.restype = ctypes.c_void_p
    enc = lib.JxlEncoderCreate(None)
    if not enc:
        raise RuntimeError("JxlEncoderCreate failed")
    try:
        info = _BasicInfo()
        lib.JxlEncoderInitBasicInfo(ctypes.byref(info))
        info.xsize = w
        info.ysize = h
        info.bits_per_sample = bits
        info.exponent_bits_per_sample = ebits
        ncolor = 3 if nchan >= 3 else 1
        info.num_color_channels = ncolor
        info.num_extra_channels = nchan - ncolor
        if nchan in (2, 4):  # gray+alpha / rgb+alpha
            info.alpha_bits = bits
            info.alpha_exponent_bits = ebits
        if lossless:
            info.uses_original_profile = 1
        if lib.JxlEncoderSetBasicInfo(ctypes.c_void_p(enc), ctypes.byref(info)):
            raise RuntimeError("JxlEncoderSetBasicInfo failed")
        ce = _ColorEncoding()
        lib.JxlColorEncodingSetToSRGB(
            ctypes.byref(ce), ctypes.c_int(1 if ncolor == 1 else 0)
        )
        if lib.JxlEncoderSetColorEncoding(ctypes.c_void_p(enc), ctypes.byref(ce)):
            raise RuntimeError("JxlEncoderSetColorEncoding failed")
        fs = lib.JxlEncoderFrameSettingsCreate(ctypes.c_void_p(enc), None)
        if not fs:
            raise RuntimeError("JxlEncoderFrameSettingsCreate failed")
        if lossless:
            if lib.JxlEncoderSetFrameLossless(ctypes.c_void_p(fs), 1):
                raise RuntimeError("JxlEncoderSetFrameLossless failed")
        # frame-settings option 0 = effort (jxl/encode.h)
        lib.JxlEncoderFrameSettingsSetOption(
            ctypes.c_void_p(fs), ctypes.c_int(0), ctypes.c_int64(effort)
        )
        fmt = _PixelFormat(
            num_channels=nchan, data_type=jxl_type, endianness=0, align=0
        )
        if lib.JxlEncoderAddImageFrame(
            ctypes.c_void_p(fs),
            ctypes.byref(fmt),
            arr.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_size_t(arr.nbytes),
        ):
            raise RuntimeError("JxlEncoderAddImageFrame failed")
        lib.JxlEncoderCloseInput(ctypes.c_void_p(enc))

        chunks = []
        chunk = (ctypes.c_uint8 * (1 << 20))()
        while True:
            next_out = ctypes.cast(chunk, ctypes.POINTER(ctypes.c_uint8))
            avail = ctypes.c_size_t(len(chunk))
            status = lib.JxlEncoderProcessOutput(
                ctypes.c_void_p(enc),
                ctypes.byref(next_out),
                ctypes.byref(avail),
            )
            produced = len(chunk) - avail.value
            chunks.append(bytes(bytearray(chunk)[:produced]))
            if status == _ENC_SUCCESS:
                return b"".join(chunks)
            if status != _ENC_NEED_MORE_OUTPUT:
                raise RuntimeError(f"JXL encode error (status {status})")
    finally:
        lib.JxlEncoderDestroy(ctypes.c_void_p(enc))
