"""Image sources: lazy 5-D ``TCZYX`` assembly from TIFF/zarr inputs
(counterpart of ``aliby_tpu/io/image.py``).

Single-page TIFFs are read by the port's native decoder
(``aliby_tpu_torch.native``), as the reference reads them; anything it
returns None on, and every other image file, is read with imageio, and
multi-page TIFFs with PIL, both imported inside the reading functions (the
GPU hosts of the port have neither).

Reference behaviors mirrored (``aliby/io/image.py``):

- ``dispatch_image`` source routing (``image.py:53-74``): list/tuple or dict
  with a list ``path`` -> ``ImageList``; other dict -> ``ImageZarr``; ``"*"``
  wildcard -> ``ImageList``; ``.zarr`` suffix -> ``ImageZarr``; ``.tif*``
  suffix -> ``ImageMultiTiff``; existing directory -> ``ImageDir``.
- ``adjust_dimensions`` (``image.py:527-599``): align capture_order to ndim
  (naming unnamed leading dims from dimorder's missing dims, filled from the
  end, padded with '?'), squeeze size-1 dims not in dimorder, append missing
  dims as trailing size-1 axes (sorted), then permute to dimorder.
- ``ImageList`` (``image.py:330-474``): pre-sorted file list forms a C-order
  grid over the cross-file ``TCZ`` dims (sizes counted from regex captures,
  ``get_dims_from_names`` asserting ``len(files) == prod(sizes)``); each file
  holds ``input_dimensions`` (default ``YX``); ``image_id`` is the MD5 of all
  file contents.

The dask layer is replaced by index-translation lazy views plus an on-demand
file/chunk loader (``aliby_tpu_torch.io.lazy``) — frames land in numpy exactly when
a tiler asks for them, with LRU caching and optional prefetch.
"""

from __future__ import annotations

import hashlib
import re
import warnings
from glob import glob
from pathlib import Path

import numpy as np

from aliby_tpu_torch.io import zarrlite
from aliby_tpu_torch.io.lazy import (
    FileGridArray,
    LazyView,
    lazy_expand_last,
    lazy_moveaxis,
    lazy_squeeze,
)
from aliby_tpu_torch.utils.profiling import span

DEFAULT_DIMORDER = "TCZYX"


def _read_image_file(path: str | Path) -> np.ndarray:
    """Read one image file into numpy; native TIFF decoder first, imageio
    for everything else (and the TIFF variants the decoder does not read).
    A span ``io.decode`` a file read."""
    with span("io.decode"):
        if ".tif" in Path(path).suffix:
            from aliby_tpu_torch import native

            arr = native.tiff_decode(path)
            if arr is not None:
                return arr
        import imageio.v3 as iio

        return np.asarray(iio.imread(str(path)))


def _read_multipage(path: str | Path) -> np.ndarray:
    """Read all pages/series of a multi-page TIFF stacked on a leading axis."""
    from PIL import Image as PILImage

    with PILImage.open(str(path)) as im:
        n = getattr(im, "n_frames", 1)
        if n == 1:
            return np.asarray(im)
        pages = []
        for i in range(n):
            im.seek(i)
            pages.append(np.asarray(im))
    return np.stack(pages)


# ---------------------------------------------------------------------------
# adjust_dimensions — the load-bearing index algebra
# ---------------------------------------------------------------------------


def adjust_dimensions(pixels, capture_order: str, dimorder: str = DEFAULT_DIMORDER):
    """Normalize an array's axes from ``capture_order`` to ``dimorder``.

    Works on numpy arrays and on lazy indexables (zero materialization).
    Semantics match the reference exactly (``aliby/io/image.py:527-599``).
    """
    ndim = len(pixels.shape)
    # 1. Align capture_order to the actual rank.
    if ndim > len(capture_order):
        missing = [d for d in dimorder if d not in capture_order]
        n_extra = ndim - len(capture_order)
        # Dims like Z/C usually sit closer to YX than T: take from the end.
        chosen = missing[-n_extra:] if n_extra <= len(missing) else missing
        if len(chosen) < n_extra:
            chosen = ["?"] * (n_extra - len(chosen)) + chosen
        capture_order = "".join(chosen) + capture_order
    elif ndim < len(capture_order):
        capture_order = capture_order[-ndim:]

    # 2. Squeeze axes absent from dimorder (must be singleton).
    axes = list(capture_order)
    out = pixels
    for i in range(len(axes) - 1, -1, -1):
        if axes[i] not in dimorder:
            if out.shape[i] != 1:
                raise AssertionError(
                    f"Dimension {axes[i]} at index {i} has size {out.shape[i]}; "
                    f"not in dimorder {dimorder} so it must be 1 to be squeezed."
                )
            out = lazy_squeeze(out, i)
            axes.pop(i)

    # 3. Append missing dims as trailing singleton axes (sorted by name).
    for dim in sorted(d for d in dimorder if d not in axes):
        out = lazy_expand_last(out)
        axes.append(dim)

    if len(axes) != len(dimorder):
        raise AssertionError(
            f"Post-adjustment capture order ({''.join(axes)}) and dimorder "
            f"({dimorder}) do not match."
        )

    # 4. Permute into dimorder.
    order = [axes.index(d) for d in dimorder]
    if order != list(range(len(order))):
        out = lazy_moveaxis(out, order)
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def dispatch_image(source):
    """Pick the Image class able to read ``source``."""
    if isinstance(source, (list, tuple)) or (
        isinstance(source, dict) and isinstance(source.get("path"), (list, tuple))
    ):
        if not len(source):
            raise AssertionError(f"Empty source {source}")
        return ImageList
    if isinstance(source, dict):
        return ImageZarr
    p = Path(source)
    if "*" in str(p):
        return ImageList
    if p.suffix == ".zarr":
        return ImageZarr
    if ".tif" in p.suffix:
        return ImageMultiTiff
    if p.is_dir():
        if zarrlite.is_zarr_node(p) or any(
            zarrlite.is_zarr_node(c) for c in p.iterdir() if c.is_dir()
        ):
            return ImageZarr
        return ImageDir
    return None


def instantiate_image(source, **kwargs):
    return dispatch_image(source)(source, **kwargs)


# ---------------------------------------------------------------------------
# Image classes
# ---------------------------------------------------------------------------


class BaseImage:
    """Common surface: ``.data`` (lazy 5-D TCZYX), ``.name``, ``.meta``."""

    default_dimorder = DEFAULT_DIMORDER

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def data(self):
        return self.get_data_lazy()

    def get_data_lazy(self):  # pragma: no cover - abstract
        raise NotImplementedError


class ImageList(BaseImage):
    """A (pre-sorted) list of 2-D/3-D/4-D image files forming one position.

    The cross-file axes are the ``TCZ`` dims named in ``capture_order`` whose
    values vary across filenames; sizes are unique-value counts per capture
    group. Files must arrive sorted in C-order over those dims (dataset
    discovery guarantees this — ``aliby/io/dataset.py:161-212``).
    """

    def __init__(
        self,
        source,
        regex: str,
        capture_order: str,
        dimorder: str | None = None,
        input_dimensions: str = "YX",
        **kwargs,
    ):
        if isinstance(source, dict):
            source = source["path"]
        self.path = source
        self.regex = regex
        self.capture_order = capture_order
        self.input_dimensions = input_dimensions
        self._dimorder = dimorder or DEFAULT_DIMORDER
        if isinstance(source, str):
            self.image_filenames = sorted(
                f for f in glob(source) if re.match(regex, f)
            )
        else:
            self.image_filenames = list(source)
        self.image_id = calculate_checksum(self.image_filenames)
        self._img = None

    @property
    def dimorder(self) -> str:
        return self._dimorder

    @property
    def dimorder_d(self) -> dict[str, int]:
        return get_dims_from_names(
            self.image_filenames, self.regex, self.capture_order
        )

    @property
    def name(self) -> str:
        if isinstance(self.path, (list, tuple)) and len(self.path):
            return Path(self.path[0]).parent.stem
        if isinstance(self.path, str) and "*" in self.path:
            return Path(self.path).parent.stem
        return Path(self.path).stem

    @property
    def meta(self) -> dict:
        meta = {f"size_{d}": v for d, v in self.dimorder_d.items()}
        if self._img is not None:
            meta.update(
                {f"size_{d}": s for d, s in zip(self._dimorder, self._img.shape)}
            )
        return meta

    def get_data_lazy(self):
        if self._img is not None:
            return self._img
        dims_d = self.dimorder_d
        infile_dims = [d for d in self.input_dimensions if d in "TCZ"]
        if not (set("TCZ") & set(dims_d)) and self.input_dimensions == "YX":
            raise AssertionError(
                "Insufficient information to build multidimensional array."
            )
        sample = _read_image_file(self.image_filenames[0])
        if sample.ndim != len(self.input_dimensions):
            raise AssertionError(
                "The number of dimensions in one of the input files must "
                f"match input_dimensions={self.input_dimensions!r}"
            )
        # Cross-file grid: TCZ dims not provided inside each file, C-order.
        grid_names = [d for d in "TCZ" if d not in infile_dims]
        grid_shape = tuple(dims_d.get(d, 1) for d in grid_names)
        files = self.image_filenames
        grid = FileGridArray(
            grid_shape,
            tuple(sample.shape),
            sample.dtype,
            loader=lambda i: _read_image_file(files[i]),
        )
        actual_order = "".join(grid_names) + self.input_dimensions
        self._img = adjust_dimensions(
            LazyView(grid, list(range(len(grid.shape)))),
            capture_order=actual_order,
            dimorder=self._dimorder,
        )
        return self._img


class ImageZarr(BaseImage):
    """One position = one array node in a zarr store (v2 or v3)."""

    def __init__(
        self,
        source,
        capture_order: str = "CYX",
        dimorder: str = DEFAULT_DIMORDER,
        **kwargs,
    ):
        if isinstance(source, dict):
            self.key = source.get("key")
            self.path = source["path"]
        else:
            self.key = kwargs.get("key")
            self.path = source
        self.capture_order = capture_order
        self.dimorder = dimorder
        self._img = None
        self._arr = None

    def _resolve_array(self) -> zarrlite.ZarrArray:
        root = Path(self.path)
        if zarrlite.is_zarr_node(root) and (
            (root / ".zarray").exists() or (root / "zarr.json").exists()
        ):
            try:
                return zarrlite.ZarrArray(root)
            except ValueError:
                pass  # a group: fall through to key lookup
        if self.key is not None and (root / str(self.key)).exists():
            return zarrlite.ZarrArray(root / str(self.key))
        arrays = zarrlite.open_group(root)
        if self.key is not None and self.key in arrays:
            return zarrlite.ZarrArray(arrays[self.key])
        if len(arrays) == 1:
            return zarrlite.ZarrArray(next(iter(arrays.values())))
        raise FileNotFoundError(
            f"Cannot resolve zarr array for key={self.key!r} under {root}"
        )

    def get_data_lazy(self):
        if self._img is None:
            self._arr = self._resolve_array()
            lazy = LazyView(self._arr, list(range(self._arr.ndim)))
            self._img = adjust_dimensions(
                lazy, capture_order=self.capture_order, dimorder=self.dimorder
            )
        return self._img

    @property
    def name(self) -> str:
        if self._arr is None:
            self.get_data_lazy()
        return str(self._arr.path)

    @property
    def meta(self) -> dict:
        return zarrlite.read_attrs(Path(self.path))


class ImageMultiTiff(BaseImage):
    """A single multi-page TIFF holding a full position."""

    def __init__(self, source, capture_order: str, dimorder: str | None = None, **kwargs):
        self.path = Path(source)
        self.capture_order = capture_order
        self._dimorder = dimorder or DEFAULT_DIMORDER
        pages = _read_multipage(self.path)
        self._img = adjust_dimensions(
            pages, capture_order=capture_order, dimorder=self._dimorder
        )

    def get_data_lazy(self):
        return self._img

    @property
    def dimorder(self) -> str:
        return self._dimorder

    @property
    def name(self) -> str:
        return str(self.path)

    @property
    def meta(self) -> dict:
        return {
            f"size_{d}": s for d, s in zip(self._dimorder, self._img.shape)
        }


class ImageDir(BaseImage):
    """A flat directory of per-(t,c,z) TIFFs named ``<name>_t###_c##_z##.tiff``."""

    def __init__(self, path, **kwargs):
        self.path = Path(path)
        self.image_id = str(self.path.stem)
        self.meta = files_to_image_sizes(self.path)
        self._img = None

    @property
    def name(self) -> str:
        return self.path.stem

    @property
    def dimorder(self) -> list[str]:
        return [k.split("_")[-1] for k in self.meta if k.startswith("size")]

    def get_data_lazy(self):
        if self._img is not None:
            return self._img
        files = sorted(self.path.glob("*.tiff")) or sorted(self.path.glob("*.tif"))
        if not files:
            raise FileNotFoundError(f"No TIFFs under {self.path}")
        sample = _read_image_file(files[0])
        dims = [d.upper() for d in self.dimorder]
        if dims:
            sizes = [self.meta[f"size_{d.lower()}"] for d in dims]
            if int(np.prod(sizes)) == len(files):
                grid = FileGridArray(
                    tuple(sizes),
                    tuple(sample.shape),
                    sample.dtype,
                    loader=lambda i: _read_image_file(files[i]),
                )
                order = "".join(dims) + "YX"
                self._img = adjust_dimensions(
                    LazyView(grid, list(range(len(grid.shape)))),
                    capture_order=order,
                )
                return self._img
        # Fallback: stack files along T.
        grid = FileGridArray(
            (len(files),),
            tuple(sample.shape),
            sample.dtype,
            loader=lambda i: _read_image_file(files[i]),
        )
        self._img = adjust_dimensions(
            LazyView(grid, list(range(len(grid.shape)))), capture_order="TYX"
        )
        return self._img


# ---------------------------------------------------------------------------
# Filename helpers
# ---------------------------------------------------------------------------


def get_dims_from_names(
    image_filenames: list[str], regex: str, capture_order: str
) -> dict[str, int]:
    """Unique-value counts per capture group; asserts the grid is complete."""
    regex_ = re.compile(regex)
    matches = [regex_.match(str(x)).groups() for x in image_filenames]
    if len(capture_order) != len(matches[0]):
        raise AssertionError(
            f"capture_order ({capture_order}) should match the number of "
            f"groups in the regex: {regex}"
        )
    dim_size = {
        dim: len({m[i] for m in matches}) for i, dim in enumerate(capture_order)
    }
    if len(image_filenames) != int(np.prod(list(dim_size.values()))):
        raise Exception(
            "The number of available images does not match the expected one "
            "given the dimensions and their maximum values. Please remove "
            "extra files."
        )
    return dim_size


def filename_to_dict_indices(stem: str) -> dict[str, int]:
    """``name_t001_c02_z3`` -> ``{"t": 1, "c": 2, "z": 3}``."""
    out = {}
    for token in stem.split("_")[1:]:
        m = re.fullmatch(r"([A-Za-z])0*(\d+)", token)
        if m:
            out[m.group(1)] = int(m.group(2))
    return out


def files_to_image_sizes(path: Path, suffix: str = "tiff") -> dict:
    """Deduce grid sizes from ``_t###_c##``-style filenames."""
    filenames = sorted(Path(path).glob(f"*.{suffix}"))
    try:
        dimorder = "".join(t[0] for t in filenames[0].stem.split("_")[1:])
        values = [filename_to_dict_indices(f.stem) for f in filenames]
        meta = {}
        for dim in dimorder:
            vs = [v[dim] for v in values]
            meta[f"size_{dim}"] = max(vs) - min(vs) + 1
        return meta
    except Exception as e:  # reference degrades gracefully (image.py:95-97)
        warnings.warn(f"files_to_image_sizes failed: {e}")
        return {}


def calculate_checksum(filenames: list[str]) -> str:
    """MD5 over the concatenated contents of all files (identity of a position)."""
    h = hashlib.md5()
    for fn in filenames:
        h.update(Path(fn).read_bytes())
    return h.hexdigest()
