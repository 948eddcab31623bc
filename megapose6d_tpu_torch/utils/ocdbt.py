"""OCDBT key-value stores, the stores orbax writes its checkpoints into
through tensorstore: `OcdbtStore` reads one, `write_ocdbt` writes one.

The JAX package leaves this to tensorstore and has no counterpart. The
format is tensorstore's "OCDBT format" page
(https://google.github.io/tensorstore/kvstore/ocdbt/index.html); where the
page leaves the layout open, it is what tensorstore writes and reads (held
against tensorstore on the committed checkpoints and on stores it writes in
`tests/test_torch_orbax.py`):

  - Every manifest and node file starts with a big-endian magic
    (`0x0cdb3a2a` manifest, `0x0cdb1234` version tree node, `0x0cdb20de`
    b-tree node), a u64 LE length of the whole encoding, a varint format
    version (0) and a varint compression (0 none, 1 zstd). The body follows
    (a zstd frame when compressed), then a CRC-32C (u32 LE) of all the
    bytes before it.
  - The manifest holds the config (16-byte uuid, varint manifest kind,
    max inline value bytes, max decoded node bytes, a u8 version tree arity
    log2, a varint compression method and, for zstd, an i32 LE level), then
    a data file table, the newest versions inline, and references to
    version tree nodes that hold the older ones.
  - A data file table is a varint count, the prefix lengths (each path
    against the one before; none for the first), the suffix lengths and the
    base path lengths, then the suffixes. A path is resolved against the
    base path of the file the table was read from.
  - A version is (generation, root height, root node's file / offset /
    length, keys, tree bytes, indirect value bytes, u64 commit time), each
    a column of varints (height u8) over the versions. A root at offset and
    length 2**64 - 1 is an empty tree.
  - A b-tree node is its u8 height, a data file table and a varint count
    of entries. Keys are columns of prefix lengths (against the key before),
    suffix lengths, and in interior nodes the length of the child's common
    prefix, then the suffix bytes; a node's keys omit the prefix that its
    parents took out. A leaf then has each value's length and kind (0
    inline, 1 in a data file), the file and offset of each indirect value,
    and the inline values' bytes. An interior node has each child's file,
    offset, length, keys, tree bytes and indirect value bytes.

    store = OcdbtStore("runs/refiner_dr/checkpoints/epoch_27000")
    store.list()                      # every key, sorted
    store.read("step/.zarray")        # its stored bytes

Values are read from their data files by offset and length, so a reader
of some keys never reads the files that hold only the others. Nodes are
zstd-decoded by `native/zstd.cc`; a bad magic, CRC, length or layout raises
ValueError, a missing file FileNotFoundError.

    write_ocdbt("ckpt", {"step/.zarray": b"...", "step/0": b"..."})

writes a new store as tensorstore lays out one commit of a single process
(held against tensorstore's own stores in `tests/test_torch_orbax_write.py`):
one version, generation 1, inline in the manifest; values over
`MAX_INLINE_VALUE_BYTES` in one data file `d/<32 hex digits>` in key
order, then the b-tree's nodes in the same file, leaves first, a level at
a time, and the root last. A level is split into nodes as tensorstore
splits it (`_partition`: its size estimate and split points, read off
stores it writes), so a store of more keys than one node of
`MAX_DECODED_NODE_BYTES` holds has the leaves and interior nodes of
tensorstore's store of the same keys when tensorstore writes them in one
commit (it may split a large transaction into several, and then its tree
differs); at orbax's limit (100 MB) a checkpoint is one leaf. The config
is orbax's: a random uuid, inline values up to 1024 bytes, version tree
arity 16, and zstd (level 0: libzstd's default) for the manifest and the
nodes, which `native/zstd.cc` encodes.
"""

from __future__ import annotations

import os
import secrets
import struct
import time
from dataclasses import dataclass
from pathlib import Path

from .. import native

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
_MISSING = 2**64 - 1
_HEADER = 14  # magic, length, and the one-byte version and compression varints
_MAX_MANIFEST_BYTES = 1 << 24
MAX_INLINE_VALUE_BYTES = 1024  # orbax's OCDBT config
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class _Reader:
    """Cursor over a decoded body; every read past its end raises."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"OCDBT {self.what}: cut short")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"OCDBT {self.what}: {len(self.data) - self.pos} bytes after its end")


def decode_envelope(data: bytes, magic: int, what: str, max_size: int) -> bytes:
    """The body of a manifest or node encoding, after its header, length
    and CRC-32C are checked (decompressed when the header says zstd)."""
    if len(data) < _HEADER + 4:
        raise ValueError(f"OCDBT {what}: {len(data)} bytes, too short")
    got_magic, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"OCDBT {what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise ValueError(f"OCDBT {what}: header says {length} bytes, found {len(data)}")
    crc = struct.unpack("<I", data[-4:])[0]
    if native.crc32c(data[:-4]) != crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    version, compression = data[12], data[13]
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version}")
    if compression == 0:
        return data[_HEADER:-4]
    if compression == 1:
        return native.decode_zstd(data[_HEADER:-4], max_size)
    raise ValueError(f"OCDBT {what}: compression {compression}")


def _data_file_table(r: _Reader, base: str) -> tuple[list[str], list[str]]:
    """The table's file paths and base paths, both resolved against `base`."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    paths, bases, prev = [], [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad data file prefix")
        path = prev[: prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"OCDBT {r.what}: bad data file base path")
        paths.append(base + path.decode())
        bases.append(base + path[: base_len[i]].decode())
        prev = path
    return paths, bases


def _keys(r: _Reader, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    """A node's keys (relative to its inherited prefix) and, in an interior
    node, the lengths of its children's common prefixes."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad key prefix")
        key = prev[: prefix[i]] + r.take(suffix[i])
        keys.append(key)
        prev = key
    if any(c > len(k) for c, k in zip(common, keys)):
        raise ValueError(f"OCDBT {r.what}: bad subtree prefix")
    return keys, common


@dataclass(frozen=True)
class NodeRef:
    """Where a node is: its file (relative to the store's root), offset and
    length; `base` is the file's base path, which the node's own data file
    table is resolved against."""
    file: str
    base: str
    offset: int
    length: int


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: NodeRef | None  # None: the empty tree
    num_keys: int
    commit_time: int


@dataclass(frozen=True)
class _VersionNodeRef:
    node: NodeRef
    generation: int
    num_generations: int
    height: int


@dataclass(frozen=True)
class Value:
    """A stored value: inline bytes, or a range of a data file."""
    inline: bytes | None
    file: str = ""
    offset: int = 0
    length: int = 0


def _node_ref(paths: list[str], bases: list[str], fid: int, offset: int, length: int, what: str) -> NodeRef:
    if fid >= len(paths):
        raise ValueError(f"OCDBT {what}: data file {fid} not in its table")
    return NodeRef(paths[fid], bases[fid], offset, length)


class OcdbtStore:
    """The keys and values of one version of an OCDBT store (by default the
    newest) in the directory `root`. The b-tree is read when the store is
    opened; `read` then only reads values, so threads may share a store."""

    def __init__(self, root: str | Path, generation: int | None = None):
        self.root = Path(root)
        self._files: dict[str, bytes] = {}
        body = decode_envelope((self.root / "manifest.ocdbt").read_bytes(), MANIFEST_MAGIC, "manifest",
                               _MAX_MANIFEST_BYTES)
        r = _Reader(body, "manifest")
        r.take(16)  # uuid
        kind = r.varint()
        max_inline = r.varint()
        # A node holds at least one entry, so it may pass the configured
        # limit by one inline value and its key; more is refused as corrupt.
        self.max_node_bytes = r.varint() + max_inline + (1 << 16)
        self.arity_log2 = r.u8()
        if r.varint() == 1:  # zstd, and its level
            r.take(4)
        if kind != 0:
            raise ValueError("OCDBT manifest: a numbered manifest (kind 1) is not read")
        versions, refs = self._version_leaf_or_refs(r, 0, "", with_height=True)
        r.end()
        self.version = self._find_version(versions, refs, generation)
        self._index: dict[bytes, Value] = {}
        if self.version.root is not None:
            self._walk(self.version.root, self.version.root_height, b"", self._index)
        self._files.clear()  # node files; values are read by range

    # -- versions ----------------------------------------------------------

    def _version_leaf_or_refs(self, r: _Reader, height: int, base: str, with_height: bool = False):
        """The manifest's (versions, version node references), or a version
        tree node's entries: versions at height 0, references above."""
        paths, bases = _data_file_table(r, base)
        versions: list[Version] = []
        if height == 0:
            n = r.varint()
            gens = r.varints(n)
            heights = [r.u8() for _ in range(n)]
            fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            num_keys = r.varints(n)
            r.varints(n)  # tree bytes
            r.varints(n)  # indirect value bytes
            times = [r.u64() for _ in range(n)]
            for i in range(n):
                root = None
                if offsets[i] != _MISSING or lengths[i] != _MISSING:
                    root = _node_ref(paths, bases, fids[i], offsets[i], lengths[i], r.what)
                versions.append(Version(gens[i], heights[i], root, num_keys[i], times[i]))
            if not with_height:
                return versions, []
        n = r.varint()
        gens = r.varints(n)
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        num_gens = r.varints(n)
        [r.u64() for _ in range(n)]  # commit times
        heights = [r.u8() for _ in range(n)] if with_height else [height - 1] * n
        refs = [_VersionNodeRef(_node_ref(paths, bases, fids[i], offsets[i], lengths[i], r.what), gens[i],
                                num_gens[i], heights[i]) for i in range(n)]
        return versions, refs

    def _find_version(self, versions: list[Version], refs: list[_VersionNodeRef], generation: int | None) -> Version:
        if generation is None:
            if versions:
                return max(versions, key=lambda v: v.generation)
            if not refs:
                raise ValueError("OCDBT manifest: no version")
            generation = max(ref.generation for ref in refs)
        while True:
            for v in versions:
                if v.generation == generation:
                    return v
            ref = next((x for x in refs if x.generation - x.num_generations < generation <= x.generation), None)
            if ref is None:
                raise KeyError(f"OCDBT store {self.root} has no generation {generation}")
            body = decode_envelope(self._slice(ref.node), VERSION_NODE_MAGIC, "version tree node",
                                   self.max_node_bytes)
            r = _Reader(body, "version tree node")
            if r.u8() != self.arity_log2:
                raise ValueError("OCDBT version tree node: arity differs from the manifest's")
            height = r.u8()
            if height != ref.height:
                raise ValueError(f"OCDBT version tree node: height {height}, expected {ref.height}")
            versions, refs = self._version_leaf_or_refs(r, height, ref.node.base)
            r.end()

    # -- b-tree ------------------------------------------------------------

    def _read_file(self, name: str) -> bytes:
        if name not in self._files:
            self._files[name] = (self.root / name).read_bytes()
        return self._files[name]

    def _slice(self, ref: NodeRef) -> bytes:
        data = self._read_file(ref.file)
        if ref.offset + ref.length > len(data):
            raise ValueError(f"OCDBT: {ref.file} holds {len(data)} bytes, a node ends at {ref.offset + ref.length}")
        return data[ref.offset: ref.offset + ref.length]

    def _walk(self, ref: NodeRef, height: int, prefix: bytes, out: dict[bytes, Value]) -> None:
        body = decode_envelope(self._slice(ref), BTREE_NODE_MAGIC, "b-tree node", self.max_node_bytes)
        r = _Reader(body, "b-tree node")
        if r.u8() != height:
            raise ValueError(f"OCDBT b-tree node in {ref.file}: height differs from its reference's {height}")
        paths, bases = _data_file_table(r, ref.base)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height == 0:
            lengths, kinds = r.varints(n), r.varints(n)
            if any(k not in (0, 1) for k in kinds):
                raise ValueError("OCDBT b-tree node: unknown value kind")
            indirect = [i for i in range(n) if kinds[i] == 1]
            fids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
            values = {i: Value(None, _node_ref(paths, bases, f, o, lengths[i], r.what).file, o, lengths[i])
                      for i, f, o in zip(indirect, fids, offsets)}
            for i in range(n):
                out[prefix + keys[i]] = values[i] if kinds[i] else Value(r.take(lengths[i]))
            r.end()
            return
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(n), r.varints(n), r.varints(n)  # keys, tree bytes, indirect value bytes
        r.end()
        for i in range(n):
            child = _node_ref(paths, bases, fids[i], offsets[i], lengths[i], r.what)
            self._walk(child, height - 1, prefix + keys[i][: common[i]], out)

    # -- public --------------------------------------------------------------

    def list(self) -> list[str]:
        """Every key of the version, sorted."""
        return sorted(k.decode() for k in self._index)

    def value(self, key: str) -> Value:
        """Where `key`'s value is (KeyError if the store lacks it)."""
        try:
            return self._index[key.encode()]
        except KeyError:
            raise KeyError(f"{key!r} is not in the OCDBT store {self.root}") from None

    def read(self, key: str) -> bytes:
        """`key`'s stored bytes: inline, or read from its data file by
        offset and length."""
        v = self.value(key)
        if v.inline is not None:
            return v.inline
        with open(self.root / v.file, "rb") as f:
            f.seek(v.offset)
            data = f.read(v.length)
        if len(data) != v.length:
            raise ValueError(f"OCDBT: {v.file} ends before the value of {key!r}")
        return data


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _lcp(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def encode_envelope(body: bytes, magic: int) -> bytes:
    """A manifest or node encoding: the header, `body` as a zstd frame, and
    the CRC-32C of all that; the inverse of `decode_envelope`."""
    frame = native.encode_zstd(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", _HEADER + len(frame) + 4) + b"\x00\x01"
    data = head + frame
    return data + struct.pack("<I", native.crc32c(data))


def _file_table(paths: list[str]) -> bytes:
    """A data file table of root-level paths (base paths empty)."""
    raw = [p.encode() for p in paths]
    prefix = [_lcp(raw[i - 1], raw[i]) for i in range(1, len(raw))]
    suffix = [raw[0]] + [raw[i][prefix[i - 1]:] for i in range(1, len(raw))] if raw else []
    return (_varint(len(raw)) + _varints(prefix) + _varints(len(x) for x in suffix) + _varints(0 for _ in raw)
            + b"".join(suffix))


def _keys_bytes(keys: list[bytes], common: list[int] | None) -> bytes:
    """A node's keys, each after the one before it (and, in an interior
    node, its child's common prefix lengths)."""
    prefix = [_lcp(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    suffix = [keys[0]] + [keys[i][prefix[i - 1]:] for i in range(1, len(keys))]
    return (_varints(prefix) + _varints(len(x) for x in suffix) + (_varints(common) if common is not None else b"")
            + b"".join(suffix))


@dataclass
class _Entry:
    """A leaf entry (value inline, or at `offset` in the data file) or an
    interior entry (a child node at `offset`, `length`)."""
    key: bytes  # the full key; an interior entry's is its subtree's first
    last: bytes  # the subtree's last key (a leaf entry's own)
    inline: bytes | None = None
    offset: int = 0
    length: int = 0
    num_keys: int = 1
    tree_bytes: int = 0
    indirect_bytes: int = 0


def _partition(entries: list[_Entry], limit: int, interior: bool) -> list[list[_Entry]]:
    """Runs of entries in key order, one a node, as tensorstore splits a
    level: each entry is estimated at 16 bytes, its key after the level's
    common prefix, and its inline value (50 bytes for a value in a data
    file, 74 for a child node); a node at the common prefix and its
    entries. While entries remain, the rest is to fill ceil(estimate /
    limit) nodes, and the next node takes entries until it reaches that
    share of the rest or the next entry would take it past the limit (a
    leaf takes at least one entry, an interior node two, and the level's
    last entry joins the node before it while that node is under its
    share)."""
    prefix = _lcp(entries[0].key, entries[-1].key)
    cum = [0]
    for e in entries:
        value = 74 if interior else len(e.inline) if e.inline is not None else 50
        cum.append(cum[-1] + 16 + len(e.key) - prefix + value)

    def size(i: int, j: int) -> int:
        return prefix + cum[j] - cum[i]

    nodes, i, n = [], 0, len(entries)
    while i < n:
        rest = size(i, n)
        share = rest / -(-rest // limit)
        j = i + 1
        while j < n and ((interior and j - i < 2)
                         or (size(i, j) < share and (size(i, j + 1) <= limit or j + 1 == n))):
            j += 1
        nodes.append(entries[i:j])
        i = j
    return nodes


def _node_body(height: int, entries: list[_Entry], prefix: int, data_file: str) -> bytes:
    """A b-tree node of `entries` whose keys drop their first `prefix`
    bytes (the prefix its parents took out)."""
    keys = [e.key[prefix:] for e in entries]
    if height == 0:
        indirect = [e for e in entries if e.inline is None]
        table = _file_table([data_file] if indirect else [])
        return (bytes([0]) + table + _varint(len(entries)) + _keys_bytes(keys, None)
                + _varints(e.length for e in entries) + _varints(0 if e.inline is not None else 1 for e in entries)
                + _varints(0 for _ in indirect) + _varints(e.offset for e in indirect)
                + b"".join(e.inline for e in entries if e.inline is not None))
    common = [_lcp(e.key, e.last) - prefix for e in entries]
    return (bytes([height]) + _file_table([data_file]) + _varint(len(entries)) + _keys_bytes(keys, common)
            + _varints(0 for _ in entries) + _varints(e.offset for e in entries)
            + _varints(e.length for e in entries) + _varints(e.num_keys for e in entries)
            + _varints(e.tree_bytes for e in entries) + _varints(e.indirect_bytes for e in entries))


def write_ocdbt(root: str | Path, items: dict[str, bytes]) -> None:
    """A new OCDBT store of `items` in the directory `root` (created; its
    manifest is written last), laid out as the module docstring says."""
    root = Path(root)
    if (root / "manifest.ocdbt").exists():
        raise FileExistsError(f"{root} already holds an OCDBT store")
    (root / "d").mkdir(parents=True, exist_ok=True)
    data_file = f"d/{secrets.token_hex(16)}"
    keys = sorted(k.encode() for k in items)
    entries, height, total_indirect, offset = [], 0, 0, 0
    with open(root / data_file, "wb") as f:
        for key in keys:
            value = items[key.decode()]
            if len(value) <= MAX_INLINE_VALUE_BYTES:
                entries.append(_Entry(key, key, inline=bytes(value), length=len(value)))
                continue
            f.write(value)
            entries.append(_Entry(key, key, offset=offset, length=len(value), indirect_bytes=len(value)))
            offset += len(value)
            total_indirect += len(value)
        # Each level's nodes, bottom up, until one node holds the level. A
        # node's keys drop its subtree's common prefix, which its parent's
        # entry records (the root drops none).
        while entries:
            runs = _partition(entries, MAX_DECODED_NODE_BYTES, interior=height > 0)
            level = []
            for run in runs:
                first, last = run[0].key, run[-1].last
                body = _node_body(height, run, 0 if len(runs) == 1 else _lcp(first, last), data_file)
                node = encode_envelope(body, BTREE_NODE_MAGIC)
                f.write(node)
                level.append(_Entry(first, last, offset=offset, length=len(node),
                                    num_keys=sum(e.num_keys for e in run),
                                    tree_bytes=len(node) + sum(e.tree_bytes for e in run),
                                    indirect_bytes=sum(e.indirect_bytes for e in run)))
                offset += len(node)
            if len(level) == 1:
                break
            entries, height = level, height + 1
    if not keys:
        (root / data_file).unlink()
    top = level[0] if keys else _Entry(b"", b"", offset=_MISSING, length=_MISSING)
    version = (_varint(1) + _varint(1) + bytes([height]) + _varint(0) + _varint(top.offset) + _varint(top.length)
               + _varint(len(keys)) + _varint(top.tree_bytes) + _varint(total_indirect)
               + struct.pack("<Q", time.time_ns()) + _varint(0))
    config = (secrets.token_bytes(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES) + _varint(MAX_DECODED_NODE_BYTES)
              + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(1) + struct.pack("<i", 0))
    manifest = encode_envelope(config + _file_table([data_file if keys else ""]) + version, MANIFEST_MAGIC)
    tmp = root / f"manifest.ocdbt.{os.getpid()}.tmp"
    tmp.write_bytes(manifest)
    tmp.replace(root / "manifest.ocdbt")
