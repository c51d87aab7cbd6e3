"""`groot get`: fetch a pre-clustered ARG database (counterpart of
groot_tpu/get.py).

Reference: cmd/get.go — downloads
<dbURL>/<db>.<identity>.tar, md5-verifies, untars. groot_tpu adds a
``--source`` override (local directory or file) for air-gapped machines;
checksums are the reference's own (cmd/get.go:40-46)."""

from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import urllib.request

from .version import get_base_version

AVAIL_DB = ["arg-annot", "resfinder", "card", "groot-db", "groot-core-db"]
AVAIL_IDENT = ["90"]
MD5SUMS = {
    "arg-annot.90": "d5398b7bd40d7e872c3e4a689cee4726",
    "resfinder.90": "de34ab790693cb7c7b656d537ec40f05",
    "card.90": "23b24d37edfd20016c2d8b5a522a4d10",
    "groot-db.90": "2cbbe9a89c2ce23c09575198832250d3",
    "groot-core-db.90": "f3cac49ff44624a26ea2d92171a73174",
}

DB_URL = (
    "https://github.com/will-rowe/groot/raw/master/db/"
    f"clustered-ARG-databases/{get_base_version()}/"
)


def get_database(
    database: str,
    identity: str = "90",
    out_dir: str = ".",
    source: str | None = None,
) -> str:
    """Fetch + verify + untar a database. Returns the extracted dir path."""
    if database not in AVAIL_DB:
        raise ValueError(
            f"unrecognised database ({database}); available: {AVAIL_DB}"
        )
    if identity not in AVAIL_IDENT:
        raise ValueError(
            f"unrecognised identity ({identity}); available: {AVAIL_IDENT}"
        )
    db_name = f"{database}.{identity}"
    tar_name = f"{db_name}.tar"
    os.makedirs(out_dir, exist_ok=True)
    tmp_tar = os.path.join(out_dir, "tmp.tar")
    if source:
        src = os.path.join(source, tar_name) if os.path.isdir(source) else source
        shutil.copyfile(src, tmp_tar)
    else:
        urllib.request.urlretrieve(DB_URL + tar_name, tmp_tar)
    md5 = hashlib.md5(open(tmp_tar, "rb").read()).hexdigest()
    if md5 != MD5SUMS[db_name]:
        os.remove(tmp_tar)
        raise ValueError(
            f"md5sum mismatch for {tar_name}: got {md5}, want {MD5SUMS[db_name]}"
        )
    with tarfile.open(tmp_tar) as tar:
        tar.extractall(out_dir, filter="data")
    os.remove(tmp_tar)
    return os.path.join(out_dir, db_name)
