"""Versioned fleet weight distribution over the p2p plane.

Serving fleets replicate the same model to N peers constantly — replica
spin-up, elastic-resize warm spares, RL-style weight refresh — and the
naive shape is N point-to-point copies out of one root (the root's egress
is the bottleneck: time-to-consistent-fleet grows linearly in N). This
module makes a fleet update ONE planned pipeline instead:

* a :class:`WeightPublisher` registers a named, **versioned** param-tree
  snapshot — the tree is flattened into dtype-tagged contiguous slabs
  (optionally wire-compressed through the shared host codec,
  :mod:`uccl_tpu_torch.p2p.compress`) behind a JSON manifest with per-group and
  whole-snapshot CRCs;
* subscribers **fetch-or-forward** in a relay chain: every node advertises
  one receive window, the upstream ships slab *groups* over the
  windowed SACK transport (``Channel.writev`` — chunk-granular, selective
  repeat, path steering, pull-credit-eligible), and a relay node forwards
  group g downstream the moment its CRC lands while group g+1 is still in
  flight from upstream — the root ships each chunk ONCE and the chain's
  completion time is ~one snapshot time plus (N-1) group times, sublinear
  in N (benchmarks/weight_push_bench.py measures it);
* every peer's received tree is verified (CRC per group + whole snapshot)
  and — because a lossy wire codec is applied ONCE at publish, making the
  published version its own canonical bytes — **bit-exact against the
  published version** on every peer, however many relay hops it crossed.

Wire accounting: served bytes land on
``weight_push_bytes_total{role="tx",name,src}`` (``src="publisher"`` vs
``"relay"`` splits root egress from peer forwarding) and fetched bytes on
``{role="rx",name}`` plus the fleet byte plane
``p2p_bytes_total{verb="weight_push"}`` — the service-level INGRESS verb
(tx bytes already ride the transport-level ``write`` series, so a
multi-process fleet's per-process audits see each byte once);
``weight_push_versions_total{name}`` counts publishes and
``weight_push_peers_total{name}`` counts peers reaching consistency. Each
fetch/serve runs under a ``weight_push.*`` trace span carrying the
version (docs/OBSERVABILITY.md).

Consumers: ``serving.replicate_backend(..., weights=snapshot)`` spins
replicas up on a fetched version, and ``serving.adapters.AdapterStore.
ingest`` publishes a fetched adapter.

Port of ``uccl_tpu/p2p/weight_push.py``. A published tree's leaves are
tensors on any device (or numpy arrays): :meth:`WeightPublisher.publish`
stages each to host once, and the CRCs are taken over the host bytes.
``WeightSnapshot.tree()`` gives CPU tensors (the JAX package gives numpy
arrays); the consumer places them on its device. The manifest's dtype
names are numpy's and ``ml_dtypes``' (``"float32"``, ``"bfloat16"``, ...),
so the two packages speak one wire format: either one's publisher serves
the other's ``fetch``. ``ep.elastic.admit_warm_spare`` stages a fetched
snapshot into an ``ElasticBuffer``.
"""

from __future__ import annotations

import json
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from uccl_tpu_torch import obs
from uccl_tpu_torch.p2p.channel import Channel, FifoItem
from uccl_tpu_torch.p2p.endpoint import host_array
from uccl_tpu_torch.utils.config import param
from uccl_tpu_torch.utils.logging import get_logger

_log = get_logger("P2P")

_group_bytes = param(
    "push_group_bytes",
    1 << 20,
    help="weight-push pipeline granularity: slab groups of about this many "
    "bytes are shipped (and relay-forwarded) as independent windowed "
    "transfers — smaller groups deepen the relay pipeline, larger ones "
    "amortize per-transfer overhead",
)

_PUSH_BYTES = obs.counter(
    "weight_push_bytes_total",
    "weight-push payload bytes by role (tx = served to a downstream peer, "
    "rx = fetched from upstream) and snapshot name",
)
_PUSH_VERSIONS = obs.counter(
    "weight_push_versions_total",
    "published weight-snapshot versions by name",
)
_PUSH_PEERS = obs.counter(
    "weight_push_peers_total",
    "peers that completed a verified fetch (reached consistency) by name",
)
_PUSH_RESUMED = obs.counter(
    "weight_push_resumed_groups_total",
    "slab groups SKIPPED on a resumed fetch because the partial buffer "
    "from the failed attempt already held them CRC-verified — the "
    "counter-audited face of not re-shipping a whole snapshot on a "
    "mid-transfer error",
)
# the one shared p2p byte family (p2p/endpoint.py declares it): the
# service-level verb beside the transport-level write/read/send series
_P2P_BYTES = obs.counter(
    "p2p_bytes_total",
    "bytes moved through p2p endpoints by verb",
)

_MAGIC = b"UWP1"


class FetchError(IOError):
    """A fetch died mid-transfer. ``partial`` is the WeightSnapshot as
    far as it got (manifest + partially-filled buffer) and ``groups_ok``
    the groups whose CRCs verified before the failure — pass it back as
    ``fetch(..., resume=err.partial)`` and only the missing groups cross
    the wire again (counted on ``weight_push_resumed_groups_total``)."""

    def __init__(self, msg: str, partial: "WeightSnapshot" = None,
                 groups_ok: Optional[List[int]] = None):
        super().__init__(msg)
        self.partial = partial
        self.groups_ok = list(groups_ok or [])


# -- param-tree <-> flat slabs ------------------------------------------------


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's name on the wire: numpy's (``ml_dtypes``' for the
    types numpy lacks), which is torch's without the ``torch.`` prefix."""
    return str(dtype).rsplit(".", 1)[-1]


def wire_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"weight_push: unknown dtype {name!r} in manifest")
    return dt


def _host(leaf) -> torch.Tensor:
    """One leaf staged to host: a contiguous CPU tensor (a CUDA tensor is
    copied down once; a CPU tensor or numpy array is used in place)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu").contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))


def flatten_tree(tree) -> List[Tuple[str, torch.Tensor]]:
    """Flatten a nested dict/list/tuple of tensors into sorted
    (dotted-path, contiguous CPU tensor) pairs — the pytree walk the wire
    format is defined over. Leaves on a device are staged to host here,
    once."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node, path):
        if isinstance(node, dict):
            if not node:
                raise ValueError(f"empty dict at {path or '<root>'}")
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else str(k))
            return
        if isinstance(node, (list, tuple)):
            if not node:
                raise ValueError(f"empty sequence at {path or '<root>'}")
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}" if path else str(i))
            return
        out.append((path, _host(node)))

    walk(tree, "")
    if not out:
        raise ValueError("empty param tree")
    out.sort(key=lambda kv: kv[0])
    return out


def unflatten_tree(pairs: Dict[str, torch.Tensor]):
    """Rebuild the nested structure from dotted paths (a node whose keys
    are all decimal strings becomes a list — the flatten convention)."""
    root: Dict = {}
    for path, arr in pairs.items():
        parts = path.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [build(node[k]) for k in
                    sorted(node, key=int)]
        return {k: build(v) for k, v in node.items()}

    return build(root)


# the leaves the fp8 wire codes: numpy's floating types (the JAX package
# asks ``np.issubdtype(dtype, np.floating)``, which ml_dtypes' bfloat16 and
# fp8 types are not, so they ship raw there and here alike)
_FP8_CODED = (torch.float16, torch.float32, torch.float64)


def _raw_leaf(t: torch.Tensor, wire: Optional[str]) -> bool:
    """Whether a leaf ships as raw bytes: always without a wire codec, and
    under ``fp8`` for leaves that are not of numpy's floating types (step
    counters, token ids, bfloat16) — the JAX package's rule, so both
    packages write the same snapshot."""
    return wire is None or (wire == "fp8" and t.dtype not in _FP8_CODED)


def _encode_entry(t: torch.Tensor, wire: Optional[str]
                  ) -> Tuple[torch.Tensor, np.ndarray]:
    """(canonical value, wire slab) of one host leaf. ``wire=None`` ships
    raw bytes (canonical == input). A wire codec is applied ONCE here — the
    published version's canonical value IS the decoded wire bytes, so
    every peer (any relay depth) is bit-exact against the published
    version; ``fp8`` costs one documented quantize round trip vs the
    INPUT, ``lossless`` none."""
    if _raw_leaf(t, wire):
        return t, host_array(t).reshape(-1).view(np.uint8)
    from uccl_tpu_torch.p2p import compress

    blob = compress.encode(t, wire)
    return compress.decode_any(blob), blob


def _decode_entry(raw: np.ndarray, ent: dict) -> torch.Tensor:
    if ent["enc"] == "raw":
        return (torch.from_numpy(raw.copy()).view(wire_dtype(ent["dtype"]))
                .reshape([int(s) for s in ent["shape"]]))
    from uccl_tpu_torch.p2p import compress

    return compress.decode_any(raw.copy())


class WeightSnapshot:
    """One named, versioned param-tree snapshot in wire form: a JSON
    manifest + a flat byte buffer holding every entry's slab. The
    publisher's stored record and the subscriber's fetch result are the
    same type — which is exactly what lets a relay node forward verbatim
    and re-serve."""

    def __init__(self, manifest: dict, buf: np.ndarray):
        self.manifest = manifest
        self.buf = buf  # flat uint8, manifest["total"] bytes

    @property
    def name(self) -> str:
        return self.manifest["name"]

    @property
    def version(self) -> int:
        return int(self.manifest["version"])

    @property
    def total_bytes(self) -> int:
        return int(self.manifest["total"])

    def flat(self) -> Dict[str, torch.Tensor]:
        """{dotted path: decoded CPU tensor} — the canonical published
        values."""
        out = {}
        for ent in self.manifest["entries"]:
            off, nb = int(ent["offset"]), int(ent["nbytes"])
            out[ent["key"]] = _decode_entry(self.buf[off:off + nb], ent)
        return out

    def tree(self):
        """The param tree rebuilt from the slabs (bit-exact vs what the
        publisher canonicalized)."""
        return unflatten_tree(self.flat())

    # replicate_backend/elastic call this to know the wire already counted
    params = tree

    def group_range(self, g: int) -> Tuple[int, int]:
        ents = self.manifest["entries"]
        lo, hi = self.manifest["groups"][g]
        return int(ents[lo]["offset"]), int(
            ents[hi - 1]["offset"]) + int(ents[hi - 1]["nbytes"])

    def group_crc(self, g: int) -> int:
        a, b = self.group_range(g)
        return zlib.crc32(self.buf[a:b])

    def crc(self) -> int:
        return zlib.crc32(self.buf)


def _build_snapshot(name: str, version: int, tree,
                    wire: Optional[str], group_bytes: int
                    ) -> WeightSnapshot:
    pairs = flatten_tree(tree)
    entries, slabs = [], []
    off = 0
    for key, t in pairs:
        _canon, slab = _encode_entry(t, wire)
        entries.append({
            "key": key, "dtype": dtype_name(t.dtype),
            "shape": list(t.shape), "nbytes": int(slab.nbytes),
            "offset": off, "enc": "raw" if _raw_leaf(t, wire) else wire,
        })
        slabs.append(slab)
        off += slab.nbytes
    # entry groups of ~group_bytes: the pipeline (and relay-forward) unit
    groups: List[List[int]] = []
    lo = 0
    acc = 0
    for i, ent in enumerate(entries):
        acc += ent["nbytes"]
        if acc >= group_bytes or i == len(entries) - 1:
            groups.append([lo, i + 1])
            lo, acc = i + 1, 0
    buf = np.concatenate([s.reshape(-1).view(np.uint8) for s in slabs]) \
        if slabs else np.zeros(0, np.uint8)
    manifest = {
        "name": name, "version": int(version), "wire": wire,
        "entries": entries, "groups": groups, "total": int(buf.nbytes),
        "crc": zlib.crc32(buf),
    }
    snap = WeightSnapshot(manifest, buf)
    # per-group crcs recorded so relays can verify before forwarding
    manifest["group_crcs"] = [snap.group_crc(g) for g in range(len(groups))]
    return snap


# -- the wire protocol --------------------------------------------------------
#
# Control messages ride the channel's ordered path-0 send/recv as
# MAGIC + JSON; the data plane is one-sided windowed writev into the
# subscriber's advertised whole-snapshot window, one transfer per group.


def _send_msg(chan: Channel, msg: dict) -> None:
    chan.send(_MAGIC + json.dumps(msg).encode())


def _recv_msg(chan: Channel, timeout_ms: int) -> dict:
    raw = chan.recv(timeout_ms=timeout_ms)
    if not raw.startswith(_MAGIC):
        raise IOError(f"weight_push: bad control frame {raw[:8]!r}")
    return json.loads(raw[len(_MAGIC):].decode())


def _serve_groups(chan: Channel, snap: WeightSnapshot, fifo: bytes,
                  timeout_ms: int, have_group=None,
                  src: str = "publisher", skip=frozenset()) -> None:
    """Ship every group of ``snap`` into the peer's window ``fifo`` — one
    windowed writev per group, a group control msg after each (the relay
    pipeline tick). ``have_group(g)`` blocks until group g's bytes are
    locally valid (a relay mid-fetch); None means all bytes are resident
    (the publisher). ``src`` labels the tx byte series
    (publisher|relay) — the counter-audited form of "the root ships each
    chunk once": under a relay chain the publisher-labeled tx bytes stay
    ONE snapshot however many peers reach consistency. ``skip`` holds
    groups the peer already verified locally (a resumed fetch): no bytes
    move, just a ``skipped`` control tick keeping the in-order group
    protocol intact."""
    item = FifoItem.unpack(fifo)
    if item.size < snap.total_bytes:
        raise IOError(
            f"weight_push: peer window {item.size}B < snapshot "
            f"{snap.total_bytes}B"
        )
    name = snap.name
    for g in range(len(snap.manifest["groups"])):
        if g in skip:
            _send_msg(chan, {"op": "group", "idx": g, "skipped": True,
                             "crc": int(snap.manifest["group_crcs"][g])})
            continue
        if have_group is not None:
            have_group(g)
        a, b = snap.group_range(g)
        lo, hi = snap.manifest["groups"][g]
        srcs, fifos = [], []
        for ent in snap.manifest["entries"][lo:hi]:
            off, nb = int(ent["offset"]), int(ent["nbytes"])
            srcs.append(snap.buf[off:off + nb])
            fifos.append(item.slice(off, nb).pack())
        with obs.span("weight_push.group", track="wire", snapshot=name,
                      version=snap.version, group=g, bytes=b - a):
            chan.writev(srcs, fifos, timeout_ms=timeout_ms)
        # the p2p_bytes_total{verb="weight_push"} series counts weight
        # INGRESS (fetch/import side) — tx bytes ride the transport-level
        # verb="write" series the writev already lands on, so a
        # multi-process fleet's per-process audits see each byte once
        _PUSH_BYTES.inc(b - a, role="tx", name=name, src=src)
        _send_msg(chan, {"op": "group", "idx": g,
                         "crc": int(snap.manifest["group_crcs"][g])})
    _send_msg(chan, {"op": "done", "crc": int(snap.manifest["crc"])})


class WeightPublisher:
    """The root of the push plane: holds named, versioned snapshots and
    serves fetches over channels."""

    def __init__(self, group_bytes: Optional[int] = None,
                 keep_versions: int = 2):
        self.group_bytes = group_bytes or _group_bytes.get()
        self.keep_versions = max(1, int(keep_versions))
        self._lock = threading.Lock()
        # name -> {version: WeightSnapshot}, insertion-ordered
        self._store: Dict[str, Dict[int, WeightSnapshot]] = {}

    def publish(self, name: str, tree, *, wire: Optional[str] = None,
                version: Optional[int] = None) -> int:
        """Register a snapshot of ``tree`` (tensors on any device, or numpy
        arrays) under ``name``; returns its version (auto-incremented
        unless pinned). The leaves are staged to host once. ``wire`` ∈
        {None, "fp8", "lossless"} — applied ONCE here, so the stored
        version is its own canonical bytes (module docstring)."""
        if wire not in (None, "fp8", "lossless"):
            raise ValueError(f"unknown weight-push wire {wire!r}")
        with self._lock:
            versions = self._store.setdefault(name, {})
            if version is None:
                version = max(versions) + 1 if versions else 1
            elif version in versions:
                raise ValueError(f"{name} v{version} already published")
        with obs.span("weight_push.publish", track="wire", snapshot=name,
                      version=version, wire=wire or "none"):
            snap = _build_snapshot(name, version, tree, wire,
                                   self.group_bytes)
        with self._lock:
            versions[int(version)] = snap
            while len(versions) > self.keep_versions:
                del versions[min(versions)]
        _PUSH_VERSIONS.inc(name=name)
        _log.info("weight_push: published %s v%d (%d entries, %d B%s)",
                  name, version, len(snap.manifest["entries"]),
                  snap.total_bytes, f", wire={wire}" if wire else "")
        return int(version)

    def get(self, name: str, version: Optional[int] = None
            ) -> WeightSnapshot:
        with self._lock:
            versions = self._store.get(name)
            if not versions:
                raise KeyError(f"no published snapshot named {name!r}")
            v = max(versions) if version is None else int(version)
            if v not in versions:
                raise KeyError(f"{name} v{v} not available "
                               f"(have {sorted(versions)})")
            return versions[v]

    def serve(self, chan: Channel, timeout_ms: int = 60000
              ) -> Tuple[str, int]:
        """Handle ONE fetch request on ``chan`` (blocking): manifest →
        window → groups → done. Returns (name, version) served."""
        req = _recv_msg(chan, timeout_ms)
        if req.get("op") != "fetch":
            raise IOError(f"weight_push: expected fetch, got {req}")
        snap = self.get(req["name"], req.get("version"))
        with obs.span("weight_push.serve", track="wire", snapshot=snap.name,
                      version=snap.version):
            _send_msg(chan, {"op": "manifest", **snap.manifest})
            win = _recv_msg(chan, timeout_ms)
            if win.get("op") != "window":
                raise IOError(f"weight_push: expected window, got {win}")
            _serve_groups(chan, snap, bytes.fromhex(win["fifo"]),
                          timeout_ms,
                          skip=frozenset(win.get("have", [])))
        return snap.name, snap.version

    def serve_forever(self, chan: Channel, timeout_ms: int = 60000):
        """Daemon helper: serve fetches on ``chan`` until it dies.
        Returns the started thread. A dying loop is never silent (the
        Channel CC-probe rule): the terminating exception is counted on
        ``weight_push_serve_errors_total{reason}`` and logged — a
        timed-out idle recv (no fetch arrived) is the one quiet exit."""

        def loop():
            while True:
                try:
                    self.serve(chan, timeout_ms)
                except TimeoutError:
                    return  # idle channel: nobody fetched within the window
                except Exception as e:
                    obs.counter(
                        "weight_push_serve_errors_total",
                        "weight-push serve loops terminated by an "
                        "exception, by exception class",
                    ).inc(reason=type(e).__name__)
                    _log.warning(
                        "weight_push: serve loop terminating (%s: %s)",
                        type(e).__name__, e,
                    )
                    return

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t


def _resume_groups(resume: Optional[WeightSnapshot], man: Dict,
                   buf: np.ndarray) -> List[int]:
    """CRC-verify which groups of a prior partial fetch already match
    ``man``'s published bytes, copy them into ``buf``, and return their
    indices — the guarded skip list of a resumed fetch. A resume against
    a DIFFERENT snapshot/version (the publisher moved on mid-retry)
    matches nothing and the fetch falls back to a full transfer."""
    if resume is None:
        return []
    rman = resume.manifest
    if (rman.get("name") != man["name"]
            or rman.get("version") != man["version"]
            or int(rman.get("total", -1)) != int(man["total"])
            or rman.get("group_crcs") != man["group_crcs"]
            or resume.buf.nbytes != buf.nbytes):
        return []
    tmp = WeightSnapshot(man, resume.buf)  # range math off the manifest
    have = []
    for g in range(len(man["groups"])):
        a, b = tmp.group_range(g)
        if zlib.crc32(resume.buf[a:b]) == int(man["group_crcs"][g]):
            buf[a:b] = resume.buf[a:b]
            have.append(g)
    return have


def fetch(chan: Channel, name: str, *, version: Optional[int] = None,
          forward_to: Sequence[Channel] = (), timeout_ms: int = 60000,
          resume: Optional[WeightSnapshot] = None,
          on_group=None) -> WeightSnapshot:
    """Fetch ``name`` (latest or pinned ``version``) from the upstream on
    ``chan``; with ``forward_to``, act as a relay — downstream peers'
    fetch requests are accepted against the SAME manifest and every
    verified group is forwarded the moment it lands, while later groups
    are still in flight from upstream (the pipeline that makes
    time-to-consistent-fleet sublinear in N). Returns the verified
    snapshot; raises :class:`FetchError` on CRC mismatch, version skew
    or a mid-transfer failure — the error carries the partial snapshot,
    and passing it back as ``resume=`` skips every group whose CRC
    already verified (counted ``weight_push_resumed_groups_total``)
    instead of restarting the whole snapshot. ``on_group(g)`` fires as
    each group verifies (progress hook)."""
    ep = chan.ep
    _send_msg(chan, {"op": "fetch", "name": name, "version": version})
    man = _recv_msg(chan, timeout_ms)
    if man.get("op") != "manifest":
        raise IOError(f"weight_push: expected manifest, got {man}")
    man = {k: v for k, v in man.items() if k != "op"}
    buf = np.zeros(int(man["total"]), np.uint8)
    snap = WeightSnapshot(man, buf)
    mr = ep.reg(buf)
    n_groups = len(man["groups"])
    got = threading.Event()
    lock = threading.Lock()
    landed: set = set()  # groups verified locally
    dead = [False]  # upstream fetch aborted: wake + fail the forwarders
    fail: List[BaseException] = []
    have = _resume_groups(resume, man, buf)
    if have:
        _PUSH_RESUMED.inc(len(have))
        landed.update(have)
        obs.instant("weight_push.resume", track="wire",
                    snapshot=man["name"], version=man["version"],
                    groups=len(have))

    def have_group(g: int):
        while True:
            with lock:
                if g in landed:
                    return
            if fail or dead[0]:
                raise IOError("weight_push: upstream fetch failed")
            got.wait(0.05)
            got.clear()

    def mark(g: int):
        with lock:
            landed.add(g)
        got.set()
        if on_group is not None:
            on_group(g)

    # downstream relays: accept each peer's fetch, hand it OUR manifest
    # (same name/version/groups), then forward groups as they land
    down_threads = []
    try:
        fifo = ep.advertise(mr)
        with obs.span("weight_push.fetch", track="wire",
                      snapshot=man["name"], version=man["version"],
                      relay=len(forward_to)):
            for dchan in forward_to:
                req = _recv_msg(dchan, timeout_ms)
                if req.get("op") != "fetch" or req["name"] != man["name"]:
                    raise IOError(f"weight_push: bad relay fetch {req}")
                if req.get("version") not in (None, man["version"]):
                    raise IOError(
                        f"weight_push: relay peer wants v{req['version']}"
                        f", upstream serves v{man['version']}"
                    )
                _send_msg(dchan, {"op": "manifest", **man})
                win = _recv_msg(dchan, timeout_ms)
                if win.get("op") != "window":
                    raise IOError(f"weight_push: expected window, got {win}")

                def fwd(dc=dchan, wf=bytes.fromhex(win["fifo"]),
                        sk=frozenset(win.get("have", []))):
                    try:
                        _serve_groups(dc, snap, wf, timeout_ms,
                                      have_group=have_group, src="relay",
                                      skip=sk)
                    except BaseException as e:  # surfaced on join below
                        fail.append(e)

                t = threading.Thread(target=fwd, daemon=True)
                t.start()
                down_threads.append(t)
            _send_msg(chan, {"op": "window", "fifo": fifo.hex(),
                             "have": have})
            for g in range(n_groups):
                msg = _recv_msg(chan, timeout_ms)
                if msg.get("op") != "group" or msg["idx"] != g:
                    raise IOError(f"weight_push: expected group {g}, "
                                  f"got {msg}")
                if msg.get("skipped"):
                    # our own resume skip, ticked back in order: the
                    # bytes were CRC-verified before the window opened
                    continue
                if snap.group_crc(g) != int(msg["crc"]):
                    raise IOError(
                        f"weight_push: group {g} CRC mismatch (wire "
                        f"corruption past the SACK layer)"
                    )
                a, b = snap.group_range(g)
                _PUSH_BYTES.inc(b - a, role="rx", name=man["name"])
                _P2P_BYTES.inc(b - a, verb="weight_push")
                mark(g)
            done = _recv_msg(chan, timeout_ms)
            if done.get("op") != "done" or snap.crc() != int(done["crc"]):
                raise IOError("weight_push: snapshot CRC mismatch")
            for t in down_threads:
                t.join(timeout=timeout_ms / 1e3)
            if fail:
                raise IOError(
                    f"weight_push: downstream forward failed: {fail[0]!r}"
                )
        _PUSH_PEERS.inc(name=man["name"])
        obs.instant("weight_push.consistent", track="wire",
                    snapshot=man["name"], version=man["version"])
        return snap
    except Exception as e:
        # Exception, not BaseException: KeyboardInterrupt/SystemExit must
        # terminate, not be rewrapped into the retry-with-resume contract
        ok = sorted(landed)
        raise FetchError(
            f"weight_push: fetch of {man['name']} v{man['version']} "
            f"failed with {len(ok)}/{n_groups} groups verified "
            f"({type(e).__name__}: {e}) — retry with resume= to skip "
            f"them", partial=snap, groups_ok=ok,
        ) from e
    finally:
        dead[0] = True  # no-op after success (every group landed)
        got.set()
        ep.dereg(mr)
