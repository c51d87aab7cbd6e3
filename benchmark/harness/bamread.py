"""A plain BAM reader: BGZF (gzip members) -> header references and the
order-canonical record keys (name, ref_id, pos, flag, seq_len, cigar) that
the comparison uses. Written from the SAM/BAM specification, so it shares
no code with the program's writer."""

from __future__ import annotations

import gzip
import struct
from typing import List, Tuple

Key = Tuple[str, int, int, int, int, Tuple[Tuple[int, int], ...]]


def parse(raw: bytes) -> Tuple[List[Tuple[str, int]], List[Key]]:
    """([(reference name, length)], [record key]) of a whole BAM."""
    data = gzip.decompress(raw)
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    (l_text,) = struct.unpack_from("<i", data, 4)
    o = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, o)
    o += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, o)
        o += 4
        name = data[o : o + l_name - 1].decode()
        o += l_name
        (l_ref,) = struct.unpack_from("<i", data, o)
        o += 4
        refs.append((name, l_ref))
    keys: List[Key] = []
    end = len(data)
    unpack = struct.unpack_from
    while o < end:
        (block_size,) = unpack("<i", data, o)
        b = o + 4
        ref_id, pos, l_read_name, _mapq, _bin, n_cigar, flag, l_seq = unpack(
            "<iiBBHHHi", data, b)
        name = data[b + 32 : b + 32 + l_read_name - 1].decode()
        c0 = b + 32 + l_read_name
        cig = unpack("<%dI" % n_cigar, data, c0)
        cigar = tuple((v >> 4, v & 0xF) for v in cig)
        keys.append((name, ref_id, pos, flag, l_seq, cigar))
        o = b + block_size
    return refs, keys
