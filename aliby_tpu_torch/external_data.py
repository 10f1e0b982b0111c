"""The pinned catalogue of the reference's real external test data, and a
fetcher (counterpart of ``aliby_tpu/external_data.py``; the port's own copy).

The reference pins its real data on Zenodo: the ~18 MB tarball of five
image datasets (record 19411429) and 16 production Swain-lab microscope
logs (records 14187308 and on). This module carries the same catalogue
(URLs and content hashes are public facts about the published datasets)
and a fetcher of the standard library alone (``urllib``, ``hashlib``,
``tarfile``) that verifies each download's hash, writes it under a
temporary ``.part`` name and renames it into place. A fetch without the
network raises :class:`OfflineError` and leaves no partial file.

Downloads go under ``$ALIBY_TPU_TORCH_EXTERNAL_CACHE``, else
``~/.cache/aliby_tpu_torch/external``. Nothing in the port fetches on its
own: a caller asks for :func:`get_image_data_root` or
:func:`get_swainlab_log`.
"""

from __future__ import annotations

import hashlib
import os
import tarfile
import urllib.request
from pathlib import Path

#: the reference's image-fixture tarball
IMAGE_TARBALL = {
    "url": (
        "https://zenodo.org/api/records/19411429/files/"
        "aliby_test_dataset.tar.gz/content"
    ),
    "sha256": "3a8b1b7b362f002098ba44e65622862057cfe46f0b459514bf270349c8bce4a7",
    "fname": "aliby_test_dataset.tar.gz",
    "extract_dir": "aliby_tests",
}

#: the tarball's sub-datasets (the reference's DATASETS) as the port's
#: DatasetDir arguments
IMAGE_DATASETS: list[dict] = [
    {
        "name": "crop_cellpainting_256",
        "layout": "tiff_dir",
        "regex": r".*__([A-Z][0-9]{2})__([0-9])__([A-Za-z]+)\.tif",
        "capture_order": "WFC",
        "channels": {"DNA": 0, "ER": 1, "RNA": 2, "AGP": 3, "Mito": 4},
    },
    {
        "name": "crop_cellpainting_256.zarr",
        "layout": "zarr",
        "regex": None,
        "capture_order": "CYX",
        "channels": {"DNA": 0, "ER": 1, "RNA": 2, "AGP": 3, "Mito": 4},
    },
    {
        "name": "crop_timeseries_alcatras_round_diff_dims_293",
        "layout": "tiff_dir",
        "regex": r".*/([^/]+)/.+_([0-9]{6})_([A-Za-z0-9]+)_(?:.*_)?([0-9]+)\.tif",
        "capture_order": "FTCZ",
        "channels": None,
    },
    {
        "name": "crop_timeseries_alcatras_square_same_channels_293",
        "layout": "tiff_dir",
        "regex": r".*/([^/]+)/.+_([0-9]{6})_([A-Za-z0-9]+)_(?:.*_)?([0-9]+)\.tif",
        "capture_order": "FTCZ",
        "channels": None,
    },
    {
        "name": "crop_timeseries_alcatras_square_same_channels_293.zarr",
        "layout": "zarr",
        "regex": None,
        "capture_order": "TCZYX",
        "channels": None,
    },
]

#: the 16 real Swain-lab logs that the reference's parser tests pin, by md5
#: as the published registry carries them
SWAINLAB_LOGS: dict[str, dict] = {
    "aggregates_downUpshift_glu_2_0_twice_gcd2_gcd6_gcn3_gcd7_sui2": {
        "md5": "c8d141f363152f6f40dc325cb2a79aa2",
        "url": "https://zenodo.org/api/records/14187308/files/0_aggregates_downUpshift_glu_2_0_twice_gcd2_gcd6_gcn3_gcd7_sui2log.txt/content",
    },
    "downUpshift_twice_2_0_2_glu_ura8_ura8h360a_ura8h360r": {
        "md5": "5de2bf44b09bb3f5a85cfa125a485f6f",
        "url": "https://zenodo.org/api/records/14188769/files/0_downUpshift_twice_2_0_2_glu_ura8_ura8h360a_ura8h360rlog.txt/content",
    },
    "proteinAggregates_starvation_2_0_twice_ura7ha_ura7hr_ura8_ura8ha_ura8hr": {
        "md5": "2ca216c295d977cd22b7d7db674f44e6",
        "url": "https://zenodo.org/api/records/14190257/files/0_proteinAggregates_starvation_2_0_twice_ura7ha_ura7hr_ura8_ura8ha_ura8hrlog.txt/content",
    },
    "DownUpshift_2_0_2_glu_ura_mig1msn2_phluorin_secondRound": {
        "md5": "425ff7c3387719322d4a5785661b354a",
        "url": "https://zenodo.org/api/records/14188244/files/0_DownUpshift_2_0_2_glu_ura_mig1msn2_phluorin_secondRoundlog.txt/content",
    },
    "aggregates_CTP_switch_2_0glu_0_0glu_URA7young_URA8young_URA8old_secondRun": {
        "md5": "e101a4bc2fd13f8a2125bb667a69c5f3",
        "url": "https://zenodo.org/api/records/14187963/files/0_aggregates_CTP_switch_2_0glu_0_0glu_URA7young_URA8young_URA8old_secondRunlog.txt/content",
    },
    "downUpshift_2_0_2_glu_gcd2_gcd6_gcd7": {
        "md5": "2b373a8c8bc99ae7235d2397c76eb204",
        "url": "https://zenodo.org/api/records/14190058/files/0_downUpshift_2_0_2_glu_gcd2_gcd6_gcd7_log.txt/content",
    },
    "downUpshift_four_2_0_2_glu_dual_phl__glt1_ura8_ura8": {
        "md5": "9882faaf908a517d7751cbe96c7d002d",
        "url": "https://zenodo.org/api/records/14189728/files/0_downUpshift_four_2_0_2_glu_dual_phl__glt1_ura8_ura8_log.txt/content",
    },
    "aggregates_starve_twice_glu_2_0_gcd2_gcd6_gcd7_gcn3_sui2": {
        "md5": "7c14ffbe5869fbbaec31375dabbacd97",
        "url": "https://zenodo.org/api/records/14191670/files/0_aggregates_starve_twice_glu_2_0_gcd2_gcd6_gcd7_gcn3_sui2log.txt/content",
    },
    "starve_twice_glu_2_0_2_0_ura7ha_ura7hr_ura8_ura8ha_ura8hr": {
        "md5": "87b59fb902ee7f2512498595c35e77b4",
        "url": "https://zenodo.org/api/records/14187631/files/0_starve_twice_glu_2_0_2_0_ura7ha_ura7hr_ura8_ura8ha_ura8hrlog.txt/content",
    },
    "downUpshift_2_0_2_glu_dual_phluorin__glt1_psa1_ura7__thrice": {
        "md5": "2bdc97b5e09df298834bc9bc3984f22b",
        "url": "https://zenodo.org/api/records/14189432/files/0_downUpshift_2_0_2_glu_dual_phluorin__glt1_psa1_ura7__thricelog.txt/content",
    },
    "downUpshift_twice_2_0_2_glu_ura8_phluorinMsn2_phluorinMig1": {
        "md5": "934aa9d6d6cd1ee9785aeda2a9620df7",
        "url": "https://zenodo.org/api/records/14189118/files/0_downUpshift_twice_2_0_2_glu_ura8_phluorinMsn2_phluorinMig1log.txt/content",
    },
    "downUpshift_2_0_2_glu_ura8_phl_mig1_phl_msn2": {
        "md5": "f445a1320fffedbb8d7ca28b52f6c569",
        "url": "https://zenodo.org/api/records/14188312/files/0_downUpshift_2_0_2_glu_ura8_phl_mig1_phl_msn2log.txt/content",
    },
    "downUpshift_2_0_2_glu_dual_phluorin__glt1_psa1_ura7__twice": {
        "md5": "c28ae615250828688342f30cfc2c23d0",
        "url": "https://zenodo.org/api/records/14189505/files/0_downUpshift_2_0_2_glu_dual_phluorin__glt1_psa1_ura7__twice_log.txt/content",
    },
    "DownUpshift_2_0_2_glu_ura_mig1msn2_phluorin": {
        "md5": "58f4501d68fe82cf58537f461e71abb4",
        "url": "https://zenodo.org/api/records/14188123/files/0_DownUpshift_2_0_2_glu_ura_mig1msn2_phluorinlog.txt/content",
    },
    "starve_2_0_2_0_ura7ha_ura7hr_ura8_ura8ha_ura8hr": {
        "md5": "11fdc38f868164834ceda056b53cc5f6",
        "url": "https://zenodo.org/api/records/14191292/files/0_starve_2_0_2_0_ura7ha_ura7hr_ura8_ura8ha_ura8hrlog.txt/content",
    },
    "downUpshift_2_01_2_glucose_dual_pH__dot6_nrg1_tod6": {
        "md5": "f7bb797890f45743b58f52502c9288cb",
        "url": "https://zenodo.org/api/records/14189201/files/0_downUpshift_2_01_2_glucose_dual_pH__dot6_nrg1_tod6_log.txt/content",
    },
}


def cache_root() -> Path:
    root = os.environ.get("ALIBY_TPU_TORCH_EXTERNAL_CACHE")
    if root:
        return Path(root)
    return Path.home() / ".cache" / "aliby_tpu_torch" / "external"


class OfflineError(RuntimeError):
    """Raised when a fetch is attempted without network access."""


def _digest(path: Path, algo: str) -> str:
    h = hashlib.new(algo)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fetch(url: str, dest: Path, *, sha256: str | None = None,
           md5: str | None = None, timeout: float = 60.0) -> Path:
    """Download ``url`` to ``dest`` with hash verification (idempotent)."""
    algo, want = ("sha256", sha256) if sha256 else ("md5", md5)
    if dest.exists() and want and _digest(dest, algo) == want:
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    except OSError as e:
        tmp.unlink(missing_ok=True)
        raise OfflineError(
            f"cannot fetch {url!r} ({e}); this host appears offline: the "
            "external data needs a networked machine"
        ) from e
    if want:
        got = _digest(tmp, algo)
        if got != want:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"hash mismatch for {url!r}: expected {algo}:{want}, got {got}"
            )
    tmp.replace(dest)
    return dest


def get_image_data_root(timeout: float = 120.0) -> Path:
    """Fetch (once) + unpack the reference's Zenodo image tarball; return
    the dataset root containing the 5 sub-datasets of IMAGE_DATASETS."""
    root = cache_root()
    out = root / IMAGE_TARBALL["extract_dir"]
    if out.is_dir() and any(out.iterdir()):
        return out
    tar = _fetch(
        IMAGE_TARBALL["url"], root / IMAGE_TARBALL["fname"],
        sha256=IMAGE_TARBALL["sha256"], timeout=timeout,
    )
    with tarfile.open(tar, "r:gz") as tf:
        tf.extractall(root, filter="data")
    # the tarball may unpack its members at top level or under a directory;
    # normalize to extract_dir containing the sub-dataset dirs
    if not out.is_dir():
        out.mkdir(parents=True, exist_ok=True)
        for entry in IMAGE_DATASETS:
            src = root / entry["name"]
            if src.exists():
                src.rename(out / entry["name"])
    return out


def get_swainlab_log(name: str, timeout: float = 60.0) -> Path:
    """Fetch (once) one of the 16 pinned real Swain-lab logs by name."""
    entry = SWAINLAB_LOGS[name]
    dest = cache_root() / "swainlab_logs" / f"{name}.log"
    return _fetch(entry["url"], dest, md5=entry["md5"], timeout=timeout)
