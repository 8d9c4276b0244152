"""The runtime passes, and the recorder they read.

``Recorder`` is a ``torch.overrides.TorchFunctionMode``: every torch
call a step makes passes through it, so it sees on the CPU what the
card would do:

  * host syncs: ``item``, ``tolist``, ``numpy``, ``cpu``, ``__bool__``,
    ``__int__``, ``__float__``, ``__index__``, ``nonzero`` and the other
    calls that wait for the device (``equal``, ``unique``, a boolean
    mask index, ...) on a tensor that lives on the device, and every
    blocking host-to-device copy (a tensor made from host data on the
    device, ``.to(device)`` of a host tensor, a host index into a device
    tensor), which ``torch.cuda.set_sync_debug_mode`` reports as a sync
    too. On the card a tensor's place is its device. On the CPU, where
    everything lives on one device, the recorder tells host tensors
    from device ones by their history: a tensor made from host data
    without a device, the result of ``.cpu()``, or one computed only
    from host tensors is a host tensor; every other tensor is a device
    tensor. ``.cpu()`` and ``.to()`` return a new tensor there, as they
    do on the card.
  * transfers: the bytes of every ``Tensor.to(device)``, ``.cuda()``,
    ``.cpu()`` and ``copy_`` source, even where the devices coincide and
    the call is a no-op, so a mesh of CPU devices is checked too.
  * creation sites: which call made each storage (``resident-dtype`` and
    ``replicated-store`` anchor their findings there).

Every event carries its call site: the first stack frames inside
``repro_torch`` or inside a corpus module (the analysis machinery
itself excluded).

The passes:

  resident-dtype     every N-scaled ``[..., D]`` payload of an entry
                     marked ``resident_sq8`` is int8 at both sizes, at
                     least one exists, and ``residency.resident_bytes``
                     counts it at one byte an element
  host-sync          host syncs per serve chunk, by call site, against
                     the limits the manifest holds (measured)
  cross-shard-bytes  the bytes a sharded step transfers are the same at
                     both sizes: merges move [B, k], never index rows.
                     Transfers made by the placement rules
                     (``dist/sharding.py``) are placement, not the step
  replicated-store   a placed index's distinct storages hold no more
                     bytes than the unplaced index plus the pad rows
                     (and an HNSW placement's routing sample)
"""
from __future__ import annotations

import dataclasses
import os
import sys
import warnings
import weakref
from collections import Counter, defaultdict
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.findings import Finding

ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))
PKG_DIR = os.path.dirname(ANALYSIS_DIR)
SRC_ROOT = os.path.dirname(PKG_DIR)
CORPUS_DIR = os.path.join(ANALYSIS_DIR, "corpus")
_MANIFEST = os.path.join(ANALYSIS_DIR, "manifest.py")
_PLACEMENT = os.path.join(PKG_DIR, "dist", "sharding.py")

# Calls that read a device tensor's value on the host.
_READS = {"item", "tolist", "numpy", "__bool__", "__int__",
          "__float__", "__index__", "__format__", "__repr__"}
# Calls whose output size or result the device must report first.
_WAITS = {"nonzero", "argwhere", "masked_select", "unique",
          "unique_consecutive", "equal", "allclose", "bincount"}
# Calls that index a tensor with other tensors.
_INDEXING = {"__getitem__", "__setitem__", "index_select", "index_put",
             "index_put_", "take"}
_MAKERS = {"tensor", "as_tensor", "asarray"}
# Calls that read metadata only.
_QUIET = {"__get__", "__set__", "dim", "size", "numel", "element_size",
          "is_floating_point", "__len__"}
SYNC_WARNING = "synchronizing CUDA operation"


def one_device(device) -> torch.device:
    """The one named device a gate run uses: every shard of every mesh
    shares it (``"cuda"`` names the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _anchorable(filename: str) -> bool:
    if filename.startswith(CORPUS_DIR) or filename == _MANIFEST:
        return True
    return filename.startswith(PKG_DIR) and not filename.startswith(
        ANALYSIS_DIR)


def _rel(filename: str) -> str:
    return os.path.relpath(filename, os.path.dirname(SRC_ROOT))


@dataclasses.dataclass(frozen=True)
class Site:
    """The innermost anchorable frame of a call and its caller's."""
    file: str
    line: int
    func: str
    caller: str = ""

    @property
    def key(self) -> str:
        """Line-free name of the call site (stable across edits)."""
        here = f"{os.path.relpath(self.file, PKG_DIR)}:{self.func}"
        return f"{self.caller} > {here}" if self.caller else here

    @property
    def location(self) -> str:
        return f"{_rel(self.file)}:{self.line}"


def _site() -> Optional[Site]:
    f = sys._getframe(2)
    first = None
    while f is not None:
        name = f.f_code.co_filename
        if _anchorable(name):
            if first is None:
                first = f
            else:
                return Site(first.f_code.co_filename, first.f_lineno,
                            first.f_code.co_name,
                            f"{os.path.relpath(name, PKG_DIR)}:"
                            f"{f.f_code.co_name}")
        f = f.f_back
    if first is None:
        return None
    return Site(first.f_code.co_filename, first.f_lineno,
                first.f_code.co_name)


@dataclasses.dataclass
class Event:
    kind: str            # "sync" | "transfer"
    what: str            # the torch call (and the sync's direction)
    site: Optional[Site]
    chunk: int
    nbytes: int = 0


def _tensors(obj) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _device_arg(args, kwargs) -> Tuple[bool, Any]:
    """(has a device target, the target) of a ``Tensor.to`` call."""
    if "device" in kwargs:
        return kwargs["device"] is not None, kwargs["device"]
    for a in args[1:]:
        if isinstance(a, (str, torch.device, int)) and not isinstance(
                a, bool):
            return True, a
        if isinstance(a, torch.Tensor):
            return True, a
    return False, None


class Recorder(TorchFunctionMode):
    """Counts host syncs and transfer bytes by call site (see the module
    docstring). ``track_creation`` also maps each new storage to the
    site that made it. ``sync_debug`` (a CUDA run) counts, per call, the
    syncs ``torch.cuda.set_sync_debug_mode("warn")`` reports."""

    def __init__(self, device="cpu", *, track_creation: bool = False,
                 sync_debug: bool = False) -> None:
        super().__init__()
        self.events: List[Event] = []
        # (site, call, syncs the sync debug mode reported, chunk)
        self.debug_syncs: List[Tuple[Optional[Site], str, int, int]] = []
        self.debug_unattributed = 0
        self.created: Dict[Tuple[str, int], Site] = {}
        self.chunk = 0
        self.counting = True
        self.track_creation = track_creation
        self.sync_debug = sync_debug
        self._host: Dict[int, Any] = {}
        # On a CPU run a tensor's place is modelled from its history.
        self.device = torch.device(device)
        self._model = self.device.type == "cpu"

    # -- host or device ----------------------------------------------------
    def _is_host(self, t: torch.Tensor) -> bool:
        if not self._model:
            return t.device.type == "cpu"
        ref = self._host.get(id(t))
        return ref is not None and ref() is t

    def _mark(self, t: torch.Tensor, host: bool) -> None:
        if not self._model:
            return
        key = id(t)
        if host:
            self._host[key] = weakref.ref(
                t, lambda _, k=key, h=self._host: h.pop(k, None))
        else:
            self._host.pop(key, None)

    def _names_host(self, dev) -> bool:
        """Whether a device argument means the host. On a CPU run only
        the string "cpu" does (a torch.device is the run's device)."""
        if self._model:
            return isinstance(dev, str) and dev == "cpu"
        return torch.device(dev).type == "cpu"

    # -- events --------------------------------------------------------------
    def _sync(self, what: str, site) -> None:
        if self.counting:
            self.events.append(Event("sync", what, site, self.chunk))

    def _transfer(self, what: str, site, nbytes: int) -> None:
        if self.counting:
            self.events.append(Event("transfer", what, site, self.chunk,
                                     nbytes))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _QUIET:
            return func(*args, **kwargs)
        site = _site()
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        out_host, fresh = self._before(name, args, kwargs, ins, site)
        if self.sync_debug:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = func(*args, **kwargs)
            n = sum(SYNC_WARNING in str(w.message) for w in caught)
            for w in caught:
                if SYNC_WARNING not in str(w.message):
                    warnings.warn_explicit(w.message, w.category,
                                           w.filename, w.lineno)
            if n and self.counting:
                self.debug_syncs.append((site, name, n, self.chunk))
        else:
            out = func(*args, **kwargs)
        if self._model:
            if fresh and isinstance(out, torch.Tensor) and ins and (
                    out is ins[0]):
                out = out.clone()     # a transfer makes a new tensor
            if out_host is None:
                out_host = bool(ins) and all(self._is_host(t) for t in ins)
            for t in _tensors(out):
                self._mark(t, out_host)
        if self.track_creation and site is not None:
            for t in _tensors(out):
                self.created.setdefault(
                    (str(t.device), t.untyped_storage().data_ptr()), site)
        return out

    def _before(self, name, args, kwargs, ins, site):
        """Record the call's syncs and transfers. Returns (whether its
        result lives on the host, None: as its inputs do; whether that
        result must be a new tensor)."""
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if name in ("to", "cuda", "cpu") and src is not None:
            has_dev, target = (_device_arg(args, kwargs) if name == "to"
                               else (True, name))
            if not has_dev:
                return None, False
            self._transfer(name, site, _nbytes(src))
            to_host = (self._is_host(target)
                       if isinstance(target, torch.Tensor)
                       else self._names_host(target))
            src_host = self._is_host(src)
            if src_host != to_host and not kwargs.get("non_blocking"):
                self._sync(f"{name} {'H2D' if src_host else 'D2H'}", site)
            return to_host, src_host != to_host
        if name == "copy_" and len(args) > 1:
            dst, from_ = args[0], args[1]
            self._transfer(name, site, _nbytes(from_))
            if (self._is_host(dst) != self._is_host(from_)
                    and not kwargs.get("non_blocking")):
                self._sync(f"copy_ {'D2H' if self._is_host(dst) else 'H2D'}",
                           site)
            return self._is_host(dst), False
        if name in _READS and src is not None:
            if not self._is_host(src):
                self._sync(name, site)
            return True, False
        if name in _WAITS or (name == "where" and len(args) == 1) or (
                name == "repeat_interleave" and "output_size" not in kwargs):
            if ins and not all(self._is_host(t) for t in ins):
                self._sync(name, site)
            return None, False
        if name in _MAKERS:
            data = args[0] if args else kwargs.get("data")
            dev = kwargs.get("device")
            if name == "as_tensor" and dev is None and len(args) > 2:
                dev = args[2]
            data_host = (self._is_host(data) if isinstance(
                data, torch.Tensor) else True)
            if dev is None:
                return data_host, False
            to_host = self._names_host(dev)
            if data_host and not to_host:
                self._sync(f"{name} H2D", site)
            return to_host, data_host != to_host
        if name in _INDEXING and src is not None:
            if not self._is_host(src):
                self._index_syncs(name, args, site)
            return None, False
        if not ins:
            # a factory: on the host unless it names a device
            dev = kwargs.get("device")
            return dev is None or self._names_host(dev), False
        return None, False

    def _index_syncs(self, name, args, site) -> None:
        """Syncs of indexing a device tensor: a host index or value is
        copied to the device first; a boolean mask needs its count (a
        scalar written through a mask does not)."""
        item = name in ("__getitem__", "__setitem__")
        value = args[2] if name == "__setitem__" and len(args) > 2 else None
        for t in _tensors(args[1] if item else args[1:]):
            if self._is_host(t):
                self._sync(f"{name} host index", site)
            elif t.dtype == torch.bool and (
                    name != "__setitem__" or (
                        isinstance(value, torch.Tensor) and value.ndim > 0)):
                self._sync(f"{name} mask", site)
        if isinstance(value, torch.Tensor) and value.ndim > 0 and \
                self._is_host(value):
            self._sync(f"{name} host value", site)

    # -- summaries -----------------------------------------------------------
    def syncs(self) -> List[Event]:
        return [e for e in self.events if e.kind == "sync"]

    def transfers(self) -> List[Event]:
        return [e for e in self.events if e.kind == "transfer"]

    def creation_site(self, t: torch.Tensor) -> Optional[Site]:
        return self.created.get((str(t.device),
                                 t.untyped_storage().data_ptr()))


def record(fn, device="cpu", **kw) -> Tuple[Any, Recorder]:
    """Run ``fn()`` under a fresh recorder: (its result, the recorder)."""
    rec = Recorder(device, **kw)
    with rec:
        out = fn()
    return out, rec


def _finding(pass_name, entry, message, site: Optional[Site]) -> Finding:
    if site is None:
        return Finding(pass_name, entry, message)
    return Finding(pass_name, entry, message, _rel(site.file), site.line)


# -- walking an index ---------------------------------------------------------

def walk(obj, path: str = "") -> Iterator[Tuple[str, torch.Tensor, Any,
                                                str]]:
    """(path, tensor, owning dataclass or None, field name) for every
    tensor in a dataclass / tuple / list / dict tree."""
    if isinstance(obj, torch.Tensor):
        yield path, obj, None, ""
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            sub = f"{path}.{f.name}" if path else f.name
            if isinstance(v, torch.Tensor):
                yield sub, v, obj, f.name
            elif isinstance(v, tuple) and v and all(
                    isinstance(t, torch.Tensor) for t in v):
                for j, t in enumerate(v):
                    yield f"{sub}[{j}]", t, obj, f.name
            else:
                yield from walk(v, sub)
    elif isinstance(obj, (tuple, list)):
        for j, v in enumerate(obj):
            yield from walk(v, f"{path}[{j}]")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from walk(v, f"{path}.{k}" if path else str(k))


def _span(t: torch.Tensor) -> Tuple[int, int]:
    """The byte range of its storage a tensor reaches."""
    if t.numel() == 0:
        return 0, 0
    extent = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    lo = t.storage_offset() * t.element_size()
    return lo, lo + extent * t.element_size()


def _storages(obj, skip_host_views: bool = False) -> Dict[Tuple[str, int],
                                                           Tuple[int, Any]]:
    """Distinct storages of a tree: key -> (the bytes its tensors reach,
    one tensor on it). Tensors that view one storage count once, and
    only the part of the storage they reach (a placement whose shards
    view the index's own rows holds those rows once)."""
    spans: Dict[Tuple[str, int], List[Tuple[int, int]]] = defaultdict(list)
    first = {}
    for path, t, _, _ in walk(obj):
        if skip_host_views and ".host_views" in f".{path}":
            continue
        key = (str(t.device), t.untyped_storage().data_ptr())
        spans[key].append(_span(t))
        first.setdefault(key, t)
    out = {}
    for key, ranges in spans.items():
        total, end = 0, 0
        for lo, hi in sorted(ranges):
            lo = max(lo, end)
            if hi > lo:
                total += hi - lo
                end = hi
        out[key] = (total, first[key])
    return out


# -- resident-dtype ----------------------------------------------------------

def resident_dtype(entry: str, small: Dict[str, Any], large: Dict[str, Any],
                   dim: int, rec_small: Recorder, rec_large: Recorder
                   ) -> List[Finding]:
    """Every N-scaled [..., D] payload (numel grows from small to large)
    is int8, at least one exists, and ``resident_bytes`` counts each at
    one byte an element."""
    from repro_torch.index import residency
    out: List[Finding] = []
    found = 0
    for tag, obj in small.items():
        big = dict((p, (t, o, f)) for p, t, o, f in walk(large.get(tag)))
        counted = {}
        for path, t, owner, field in walk(obj):
            if path not in big or t.ndim < 2 or t.shape[-1] != dim:
                continue
            tb = big[path][0]
            if tb.numel() <= t.numel():
                continue
            found += 1
            for tt, rec in ((t, rec_small), (tb, rec_large)):
                if tt.dtype != torch.int8:
                    out.append(_finding(
                        "resident-dtype", entry,
                        f"{tag}:{path} is an N-scaled {tuple(tt.shape)} "
                        f"{tt.dtype} payload: the SQ8-resident format "
                        f"keeps it int8 on the device",
                        rec.creation_site(tt)))
                    break
            if owner is not None and t.dtype == torch.int8:
                counted.setdefault((id(owner), field), (owner, field, 0))
                o, f, n = counted[(id(owner), field)]
                counted[(id(owner), field)] = (o, f, n + t.numel())
        for owner, field, numel in counted.values():
            got = residency.resident_bytes(owner).get(field)
            if got != numel:
                out.append(Finding(
                    "resident-dtype", entry,
                    f"{tag}: resident_bytes counts {field} as {got} bytes, "
                    f"its int8 payload holds {numel} (1 byte an element)"))
    if not found:
        out.append(Finding(
            "resident-dtype", entry,
            "no N-scaled int8 payload: an entry marked resident_sq8 must "
            "serve the SQ8-resident format"))
    return out


# -- host-sync ---------------------------------------------------------------

def sync_counts(rec: Recorder, *, debug: bool = False) -> Dict[str, int]:
    """Per call site, the most host syncs any one chunk made (``debug``:
    the syncs the sync debug mode reported, in a ``sync_debug`` run)."""
    if debug:
        per = Counter()
        for site, _, n, chunk in rec.debug_syncs:
            per[(chunk, site.key if site else "?")] += n
    else:
        per = Counter((e.chunk, e.site.key if e.site else "?")
                      for e in rec.syncs())
    out: Dict[str, int] = defaultdict(int)
    for (_, key), n in per.items():
        out[key] = max(out[key], n)
    return dict(sorted(out.items()))


def host_syncs(entry: str, rec: Recorder, limits: Dict[str, int]
               ) -> List[Finding]:
    """A finding for every call site whose syncs in one chunk exceed its
    limit (a site with no limit has limit 0), anchored at the site."""
    per = Counter((e.chunk, e.site.key if e.site else "?")
                  for e in rec.syncs())
    first = {}
    for e in rec.syncs():
        first.setdefault(e.site.key if e.site else "?", e)
    out, seen = [], set()
    for (chunk, key), n in sorted(per.items()):
        lim = limits.get(key, 0)
        if n > lim and key not in seen:
            seen.add(key)
            e = first[key]
            out.append(_finding(
                "host-sync", entry,
                f"{n} host sync(s) in one chunk at {key} ({e.what}); the "
                f"limit is {lim}", e.site))
    return out


# -- cross-shard-bytes -------------------------------------------------------

def step_bytes(rec: Recorder) -> Dict[str, int]:
    """Transfer bytes per call site, placement excluded."""
    out: Dict[str, int] = defaultdict(int)
    for e in rec.transfers():
        if e.site is not None and e.site.file == _PLACEMENT:
            continue
        out[e.site.key if e.site else "?"] += e.nbytes
    return dict(out)


def cross_shard_bytes(entry: str, rec_small: Recorder, rec_large: Recorder
                      ) -> List[Finding]:
    """The step transfers the same bytes at both sizes."""
    a, b = step_bytes(rec_small), step_bytes(rec_large)
    if sum(a.values()) == sum(b.values()):
        return []
    key = max(set(a) | set(b), key=lambda k: abs(b.get(k, 0) - a.get(k, 0)))
    site = next((e.site for e in rec_large.transfers()
                 if e.site is not None and e.site.key == key), None)
    return [_finding(
        "cross-shard-bytes", entry,
        f"the step transfers {sum(a.values())} bytes at the small size and "
        f"{sum(b.values())} at the large one ({key}: {a.get(key, 0)} -> "
        f"{b.get(key, 0)}): a merge moves [B, k], never index rows",
        site)]


# -- replicated-store --------------------------------------------------------

def _allowance(unplaced, placed) -> Tuple[int, int]:
    """(pad bytes, placement-table bytes) a placement may add to the
    unplaced index: the pad rows of each sharded field (split on the one
    axis whose S blocks each hold ceil(n / S) of n rows), and the tables
    the unplaced index lacks (an HNSW placement's gathered routing
    sample). A mutable view's base counts; its ring moves whole."""
    if getattr(placed, "base", None) is not None:
        return _allowance(unplaced.base, placed.base)
    pad = extra = 0
    for f in dataclasses.fields(placed):
        if f.name in ("host_views", "mesh"):
            continue
        v = getattr(placed, f.name)
        u = getattr(unplaced, f.name, None)
        if isinstance(v, torch.Tensor) and u is None:
            extra += _nbytes(v)
        if not (isinstance(v, tuple) and v and isinstance(
                u, torch.Tensor)):
            continue
        s = len(v)
        for a in range(u.ndim):
            n = u.shape[a]
            m = -(-n // s)
            if n and all(t.shape[a] == m and t.shape[:a] == u.shape[:a]
                         and t.shape[a + 1:] == u.shape[a + 1:]
                         for t in v):
                pad += (m * s - n) * (_nbytes(u) // n)
                break
    return pad, extra


def replicated_store(entry: str, tag: str, unplaced, placed,
                     rec: Optional[Recorder]) -> List[Finding]:
    """Each placement (host group 0's and every host view, a mutable
    view's base and ring) holds no more distinct-storage bytes than the
    unplaced index plus the pad rows (and the routing sample an HNSW
    placement gathers)."""
    base = getattr(placed, "base", None)
    hosts = getattr(placed if base is None else base, "host_views", ())
    views = [("", placed)] + [
        (f" host view {h}",
         v if base is None else dataclasses.replace(placed, base=v))
        for h, v in enumerate(hosts)]
    base_bytes = sum(n for n, _ in _storages(unplaced).values())
    pad, extra = _allowance(unplaced, placed)
    limit = base_bytes + pad + extra
    out = []
    for label, view in views:
        st = _storages(view, skip_host_views=True)
        total = sum(n for n, _ in st.values())
        if total > limit:
            ref = _storages(unplaced)
            culprit = max((v for k, v in st.items() if k not in ref),
                          key=lambda v: v[0], default=None)
            site = (rec.creation_site(culprit[1])
                    if rec is not None and culprit is not None else None)
            out.append(_finding(
                "replicated-store", entry,
                f"{tag}{label}: the placement holds {total} bytes in "
                f"distinct storages, more than the unplaced index's "
                f"{base_bytes} plus {pad} pad bytes and {extra} bytes of "
                f"placement tables: the store is copied, not split", site))
    return out
