"""Runtime configuration — the Info equivalent.

Counterpart of groot_tpu/config.py. Reference:
src/pipeline/runtime.go:15-91. Info centralises every
runtime parameter plus the graph Store, and its serialisation IS the on-disk
`groot.gg` artifact; align inherits index params by loading it. The artifact
is a gzip pickle with an explicit version gate (cmd/align.go:96-98).

One `groot.gg` format serves both packages. A pickle names each class by its
module path, and the file names the reference's five classes
(`groot_tpu.config.Info`, `AlignCmd`, `HaploCmd`,
`groot_tpu.graph.grootgraph.GrootGraph`, `GraphNode`). `Info.load` maps
exactly those names to this package's classes, without importing
groot_tpu, and refuses any other `groot_tpu.*` name. `Info.dump` writes the
same names: it pickles with protocol 3, whose GLOBAL opcode is the text
`c<module>\\n<name>\\n` with no length prefix and whose stream has no frame
lengths, so the module strings of those opcodes are rewritten in place.
"""

from __future__ import annotations

import copyreg
import gzip
import io
import os
import pickle
import pickletools
from dataclasses import dataclass, field
from typing import Optional

from .graph.grootgraph import GraphNode, GrootGraph, Store
from .version import get_version

REF_PACKAGE = "groot_tpu"


@dataclass
class AlignCmd:
    fasta: bool = False
    bloom_filter: bool = False
    min_kmer_coverage: float = 1.0
    bam_out: str = ""
    no_exact_align: bool = False


@dataclass
class HaploCmd:
    cutoff: float = 1.0
    min_iterations: int = 50
    max_iterations: int = 10000
    total_kmers: int = 0
    haplo_dir: str = ""


@dataclass
class Info:
    version: str = field(default_factory=get_version)
    # host worker parallelism (the reference's -p; its default is 1, ours
    # is the machine — the batch pipeline is sized for all host cores).
    # 0 means "unset": resolved to os.cpu_count() at load/use time, so an
    # EXPLICIT num_proc=1 (bounding CPU on a shared host) survives a
    # dump/load round-trip instead of being clobbered to the machine size.
    num_proc: int = 0
    profiling: bool = False
    kmer_size: int = 31
    sketch_size: int = 21
    window_size: int = 100
    num_part: int = 8
    max_k: int = 4
    max_sketch_span: int = 30
    containment_threshold: float = 0.99
    index_dir: str = ""
    store: Store = field(default_factory=dict)
    sketch: AlignCmd = field(default_factory=AlignCmd)
    haplotype: HaploCmd = field(default_factory=HaploCmd)
    # attached containment index (not serialised into groot.gg; runtime.go:29-32)
    db: Optional[object] = None

    def attach_db(self, db) -> None:
        self.db = db

    def save_db(self, file_path: str) -> None:
        self.db.dump(file_path)

    def dump(self, path: str) -> None:
        db = self.db
        self.db = None
        try:
            data = dumps_ref_names(self)
        finally:
            self.db = db
        with gzip.open(path, "wb") as fh:
            fh.write(data)

    @classmethod
    def load(cls, path: str) -> "Info":
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise ValueError("groot graph store appears empty")
        with gzip.open(path, "rb") as fh:
            info = _RefUnpickler(fh).load()
        if not isinstance(info, cls):
            raise ValueError(f"not a groot Info artifact: {path}")
        # resolve "unset" (0 or a pre-r4 pickle missing the field) to the
        # machine size; an explicit value — including 1 — is kept as-is
        if getattr(info, "num_proc", 0) == 0:
            info.num_proc = os.cpu_count() or 1
        return info


# the reference's (module, name) for each class groot.gg holds
REF_CLASSES = {
    (f"{REF_PACKAGE}.config", "Info"): Info,
    (f"{REF_PACKAGE}.config", "AlignCmd"): AlignCmd,
    (f"{REF_PACKAGE}.config", "HaploCmd"): HaploCmd,
    (f"{REF_PACKAGE}.graph.grootgraph", "GrootGraph"): GrootGraph,
    (f"{REF_PACKAGE}.graph.grootgraph", "GraphNode"): GraphNode,
}


def _global(module: str, name: str) -> bytes:
    return b"c" + module.encode() + b"\n" + name.encode() + b"\n"


class _CommandsFirst(pickle.Pickler):
    """Pickles an Info with its command settings ahead of its store, so
    every class this package names in the stream is named within its first
    graph."""

    def reducer_override(self, obj):
        if type(obj) is not Info:
            return NotImplemented
        state = dict(vars(obj))
        front = {k: state.pop(k) for k in ("sketch", "haplotype")}
        return copyreg.__newobj__, (Info,), {**front, **state}


def dumps_ref_names(obj) -> bytes:
    """Pickle `obj` (protocol 3) with every class of REF_CLASSES named as
    the reference names it. Only GLOBAL opcodes are rewritten, found by
    walking the opcode stream up to the last place that could name a class
    of this package, so pickled data holding the same bytes is left
    alone."""
    buf = io.BytesIO()
    _CommandsFirst(buf, protocol=3).dump(obj)
    raw = buf.getvalue()
    ref_name = {(cls.__module__, name): module
                for (module, name), cls in REF_CLASSES.items()}
    own = __name__.split(".")[0]
    stop = raw.rfind(b"c" + own.encode() + b".")
    parts, last = [], 0
    for op, arg, pos in pickletools.genops(raw) if stop >= 0 else ():
        if pos > stop:
            break
        if op.code != "c":  # GLOBAL: "c<module>\n<name>\n"
            continue
        module, name = arg.split(" ", 1)
        ref = ref_name.get((module, name))
        if ref is None:
            if module.split(".")[0] == own:
                raise pickle.PicklingError(
                    f"groot.gg would name {module}.{name}, which the "
                    "reference cannot load"
                )
            continue
        parts += [raw[last:pos], _global(ref, name)]
        last = pos + len(_global(module, name))
    parts.append(raw[last:])
    return b"".join(parts)


class _RefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == REF_PACKAGE:
            cls = REF_CLASSES.get((module, name))
            if cls is None:
                raise pickle.UnpicklingError(
                    f"groot.gg names {module}.{name}, which has no "
                    "counterpart in this package"
                )
            return cls
        return super().find_class(module, name)
