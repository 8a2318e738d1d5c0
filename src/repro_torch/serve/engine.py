"""Batched serving engine with location-aware, tier-aware session routing.

Continuous batching over a fixed pool of decode slots: each session owns one
batch slot of the shared KV-cache state; prefill admits sessions, decode steps
all active slots at once (one ``decode_step`` regardless of how many sessions
are live — idle slots are masked). This is the PyTorch port of
``repro.serve.engine``: the engine and router logic is line for line the
reference's; only :class:`TorchComputeBackend` and the slot helpers touch
tensors.

The cross-layer part (paper → inference): a session's KV cache IS the paper's
"file". The :class:`Router` records each session's placement in the
distributed :class:`~repro_torch.core.locstore.LocationService`; follow-up requests
look the session up and land on the engine/node that holds its cache
(compute-on-data-path), instead of re-prefilling elsewhere — the measured
saving is an entire prefill per follow-up turn.

Session caches are first-class replicas in the tiered
:class:`~repro_torch.core.locstore.LocStore` with their TRUE byte size (the batch-1
slice of the pooled decode state), so capacity accounting and eviction see
them:

* an **active** session's cache is pinned in the store's top tier (HBM);
* an **idle** session can be *parked* (:meth:`ServingEngine.park`): its KV
  slice is read out of the engine slot and demoted to the burst-buffer tier,
  freeing the slot for another session — under ``write_policy="back"`` the
  store's :class:`~repro_torch.core.locstore.WriteBackQueue` flushes it to the PFS
  off the critical path if the burst buffer overflows too;
* a follow-up to a parked session *resumes* it: the store promotes the cache
  back to the top tier and the engine re-hydrates the slot from the stored
  slice — no re-prefill, which is the entire point.

The :class:`Router` is pressure- and tier-aware: a locality hit on a
saturated engine is priced (media time to promote the parked cache, plus the
demotions the promotion will cause, per ``store.tier_report(node=...)``)
against a migrate-and-re-prefill on a free engine (the engine's *measured*
prefill seconds), and the cheaper side wins.

**Failover** (:meth:`Router.fail_engine`): when an engine node dies, the
storage layer takes the atomic hit (``store.drop_node``) and every parked
session whose KV slice still has a surviving replica — on another node or as
a real (durability-policy-flushed) PFS copy — is *re-hydrated on a surviving
engine* with a matching slot shape instead of re-prefilled; decode continues
bit-identically. Sessions live in a slot, or parked inside an open
durability window, are lost and need a fresh prefill.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import ServingConfig
from repro_torch.core.locstore import DropReport, JoinReport, LocStore, Placement
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.models import model as M

Pytree = Any


@dataclasses.dataclass
class KVSlice:
    """One session's KV-cache slice as a store object with a true byte size.

    ``state`` is the batch-1 decode-state pytree for a parked session, or
    ``None`` while the session is live in an engine slot (the store then
    holds a correctly-*sized* placeholder — capacity accounting and eviction
    must see the real bytes either way; the zero-byte registration of the
    pre-tiered engine hid serving traffic from the storage layer entirely).
    """

    state: Pytree | None
    nbytes: float


@dataclasses.dataclass
class Session:
    sid: int
    slot: int | None              # None while parked (KV lives in the store)
    prompt_len: int
    tokens: list[int]
    done: bool = False
    last_active: int = 0          # engine activity clock at last touch


def _cache_name(sid: int) -> str:
    return f"kvcache:session:{sid}"


def _dtype_name(dtype: Any) -> str:
    """``torch.bfloat16`` and numpy/JAX ``bfloat16`` both name ``bfloat16``;
    a numpy leaf (the synthetic trace backend's ``int64`` / ``int32``) names
    itself as the reference names it."""
    return str(dtype).removeprefix("torch.")


def _state_signature(state: Pytree) -> tuple:
    """The slot-compatibility fingerprint: pytree structure + per-leaf shape
    and dtype (one definition — ``slot_signature`` and ``compatible_state``
    must never drift apart). Dicts are walked in sorted key order, as
    ``jax.tree`` walks them, and dtype names are normalised, so the
    signature means the same whichever package produced the state. Raises
    ``TypeError`` on a leaf that is not an array."""
    leaves: list[tuple] = []

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return ("dict", tuple((k, walk(node[k])) for k in sorted(node)))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(x) for x in node))
        if not hasattr(node, "shape") or not hasattr(node, "dtype"):
            raise TypeError(f"not a decode-state leaf: {type(node).__name__}")
        leaves.append((tuple(node.shape), _dtype_name(node.dtype)))
        return "*"

    return walk(state), tuple(leaves)


def _tree_map(fn, a: Pytree, b: Pytree) -> Pytree:
    """``fn`` over the paired leaves of two states of one structure."""
    if isinstance(a, dict):
        return {k: _tree_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _leaves(state: Pytree) -> list:
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in _leaves(v)]
    return [state]


class TorchComputeBackend:
    """The real model-compute backend (and the default): prefill/decode over
    the pooled decode state on one device, slot extraction by tensor
    indexing. The counterpart of the reference's ``JaxComputeBackend``.

    The engine delegates every compute- and state-layout-touching operation
    to its backend, so the routing/park/resume/failover machinery can also be
    driven by a compute-free stand-in at 10^5-session scale — the
    storage-layer behaviour (true KV byte sizes, tier residency, eviction)
    is identical either way.

    Runs on ``cuda`` unless ``device`` says otherwise, and raises when there
    is no CUDA device rather than running on the CPU.
    """

    def __init__(self, cfg: ModelConfig, max_seq: int, *,
                 device: str | torch.device | None = None) -> None:
        cfg.validate()
        self.cfg = cfg
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self._template: Pytree | None = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def init_state(self, batch: int) -> Pytree:
        return M.init_decode_state(self.cfg, batch, self.max_seq,
                                   device=self.device)

    def slot_template(self) -> Pytree:
        """Batch-1 decode state: the shape key for slot reads/writes. Its
        tensors live on the meta device: only shapes and dtypes are read."""
        if self._template is None:
            self._template = M.init_decode_state(self.cfg, 1, self.max_seq,
                                                 device="meta")
        return self._template

    def slot_nbytes(self) -> float:
        """True size in bytes of one session's KV-cache slice."""
        return float(sum(leaf.nbytes for leaf in _leaves(self.slot_template())))

    @torch.no_grad()
    def prefill(self, params: Pytree, prompt: list[int],
                extras: dict | None) -> tuple[int, Pytree, float]:
        """Prefill one prompt; returns (first token, batch-1 state, measured
        wall seconds) — the seconds feed the router's migrate pricing, so the
        device is synchronised on both sides of the timed call."""
        tokens = torch.tensor([prompt], dtype=torch.int64, device=self.device)
        batch = {"tokens": tokens, "labels": tokens}
        key = M._EXTRAS.get(self.cfg.family)
        if key is not None:
            batch[key] = self._extra(key, extras)
        self._sync()
        with obs.span("prefill") as sp:
            t0 = time.perf_counter_ns()
            with obs.span("prefill.launch"):
                logits, fresh = M.prefill(self.cfg, params, batch,
                                          self.max_seq)
                first = torch.argmax(logits[0, -1])
            self._sync()
            t1 = time.perf_counter_ns()
            if sp.on:
                sp.at(t0, t1)
                sp.set(tokens=len(prompt))
        return int(first), fresh, (t1 - t0) / 1e9

    def _extra(self, key: str, extras: dict | None) -> torch.Tensor:
        """The stubbed frontend's input for one prompt, as the reference
        hands it over: ``extras[key]`` (frames or patches, shape (1, n, d))
        in bf16 whatever ``cfg.dtype``, or bf16 zeros of (1, n_frames |
        n_patches, d_model) when the caller gives none."""
        e = (extras or {}).get(key)
        if e is None:
            n = self.cfg.n_frames if key == "frames" else self.cfg.n_patches
            return torch.zeros((1, n, self.cfg.d_model), dtype=torch.bfloat16,
                               device=self.device)
        if not isinstance(e, torch.Tensor):
            e = torch.from_numpy(np.asarray(e, np.float32))
        return e.to(device=self.device, dtype=torch.bfloat16)

    @torch.no_grad()
    def decode(self, params: Pytree, state: Pytree,
               tokens: np.ndarray) -> tuple[np.ndarray, Pytree]:
        """One pooled decode step; returns (argmax token per slot, state).
        The pooled cache is updated in place."""
        with obs.span("decode.upload"):
            tok = torch.as_tensor(tokens, dtype=torch.int64).to(self.device)
        with obs.span("decode.launch"):
            logits, state = M.decode_step(self.cfg, params, state, tok)
            arg = torch.argmax(logits[:, -1], dim=-1)
        with obs.span("decode.readback"):
            arg = arg.cpu().numpy()
        return arg, state

    def write_slot(self, pooled: Pytree, single: Pytree, slot: int) -> Pytree:
        return _write_slot(pooled, single, slot)

    def read_slot(self, pooled: Pytree, template: Pytree, slot: int) -> Pytree:
        return _read_slot(pooled, template, slot)


@dataclasses.dataclass(frozen=True)
class FailoverReport:
    """What :meth:`Router.fail_engine` did when an engine node died.

    ``resumed`` sessions were re-homed onto a surviving engine from the
    surviving LocStore/PFS replica of their parked KV slice (into a slot, or
    still parked when the engine is saturated) — each one is an entire
    prefill NOT paid. ``lost`` sessions need a fresh prefill: they
    were live in a slot (the authoritative KV died with the engine) or their
    parked slice had no surviving replica (it was still inside the durability
    window). ``deferred`` sessions kept a durable, compatible-in-principle
    slice that no *currently registered* engine can load (including the
    all-engines-down window) — the slice stays parked-unhomed and the next
    compatible :meth:`Router.join_engine` adopts it. ``drop`` is the storage
    layer's atomic account of the failure."""

    node: int
    resumed: tuple[int, ...]
    lost: tuple[int, ...]
    drop: DropReport
    deferred: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class EngineJoinReport:
    """What :meth:`Router.join_engine` did when an engine node (re)joined.

    ``adopted`` sessions were parked-unhomed by an earlier failover (their
    durable slice had no compatible home) and re-homed onto the newcomer —
    each one a prefill NOT paid. ``rebalanced`` sessions were moved off
    saturated survivors to level parked load. ``join`` is the storage
    layer's membership report."""

    node: int
    adopted: tuple[int, ...]
    rebalanced: tuple[int, ...]
    join: JoinReport


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """What :meth:`Router.follow_up` / :meth:`Router.route` decided for one
    turn — the typed sibling of :class:`FailoverReport`.

    ``kind`` is one of:

    * ``"new"``        — no session id given: fresh admission;
    * ``"hit_live"``   — locality hit, session still in its slot (free);
    * ``"hit_parked"`` — locality hit, parked session resumed in place
                         (storage promotion, no prefill);
    * ``"migrate"``    — the holder was priced out (or the cache is gone):
                         re-prefilled on another engine, ``sid`` changed.

    ``resumed`` is True when a parked session was re-hydrated into a slot;
    ``prefilled`` when the turn paid a fresh prefill.
    """

    engine: "ServingEngine"
    sid: int
    kind: str
    resumed: bool = False
    prefilled: bool = False


class ServingEngine:
    """One engine == one node's worth of serving capacity."""

    _SID = itertools.count()      # session ids are GLOBALLY unique: the
    # location service keys caches by sid, so ids must not collide across
    # engines (the router depends on it).
    _CLOCK = itertools.count(1)   # activity ticks are ALSO global: the
    # router compares Session.last_active across engines to pick a
    # cluster-wide LRU park victim, so per-engine clocks would make a busy
    # engine's idle sessions look fresher than a quiet engine's active one.

    def __init__(self, cfg: ModelConfig | None, params: Pytree, *,
                 config: ServingConfig | None = None, node: int = 0,
                 store: LocStore | None = None, backend=None,
                 max_batch: int | None = None, max_seq: int | None = None,
                 eos_id: int | None = None, idle_tier: str | None = None,
                 device: str | torch.device | None = None) -> None:
        # ``device`` places the default TorchComputeBackend (cuda unless
        # asked otherwise); an explicit backend= carries its own device.
        # documented path: one frozen ServingConfig (shared with the Router).
        # Legacy path: the original flat keywords, mapped through
        # ServingConfig.from_kwargs. Mixing them is rejected.
        legacy = {k: v for k, v in dict(max_batch=max_batch, max_seq=max_seq,
                                        eos_id=eos_id,
                                        idle_tier=idle_tier).items()
                  if v is not None}
        if config is None:
            config = ServingConfig.from_kwargs(**legacy)
        elif legacy:
            raise TypeError("ServingEngine: pass config= OR the legacy "
                            f"keywords, not both: {sorted(legacy)}")
        self.config = config
        self.cfg = cfg
        self.params = params
        self.max_batch = config.max_batch
        self.max_seq = config.max_seq
        self.node = node
        self.store = store
        self.eos_id = config.eos_id
        self.idle_tier = config.idle_tier
        if backend is None:
            if cfg is None:
                raise TypeError("ServingEngine: cfg=None requires an "
                                "explicit backend=")
            backend = TorchComputeBackend(cfg, self.max_seq, device=device)
        elif device is not None:
            raise TypeError("ServingEngine: pass backend= OR device=, not "
                            "both")
        self.backend = backend
        self.state = backend.init_state(self.max_batch)
        self.sessions: dict[int, Session] = {}
        # sessions currently holding a slot, by sid — the router's cluster-wide
        # LRU park scan must not walk every session the engine has ever served
        self._slotted: dict[int, Session] = {}
        self._free_slots = list(range(self.max_batch))
        self.steps = 0
        self.prefills = 0
        self.parks = 0
        self.resumes = 0
        self.rehydrates = 0
        self.prefill_seconds: float | None = None   # EMA of measured prefills
        self._clock = 0
        self._slot_nbytes: float | None = None
        # runtime invariant sanitizer (repro_torch.analysis.sanitize): slot and
        # placeholder cross-checks after every state transition — opt-in via
        # config.sanitize, falling back to the REPRO_SANITIZE env var
        if config.sanitize is None:
            from repro_torch.analysis.sanitize import env_enabled
            self._sanitize = env_enabled()
        else:
            self._sanitize = bool(config.sanitize)

    def _sanitize_check(self) -> None:
        if self._sanitize:
            from repro_torch.analysis import sanitize as _san
            _san.check_engine(self)

    # ---------------------------------------------------------- KV geometry
    def _slot_template(self) -> Pytree:
        """Batch-1 decode state: the shape key for slot reads/writes and the
        true per-session KV byte size."""
        return self.backend.slot_template()

    def slot_bytes(self) -> float:
        """Size in bytes of one session's KV-cache slice (the backend's
        answer — the real leaf bytes for the torch backend, the *modeled* KV
        size for a synthetic one; the store accounts whichever it is)."""
        if self._slot_nbytes is None:
            self._slot_nbytes = float(self.backend.slot_nbytes())
        return self._slot_nbytes

    def slot_signature(self) -> tuple:
        """Shape/dtype fingerprint of one slot's KV state — two engines can
        exchange parked sessions iff their signatures match (same model
        geometry and ``max_seq``)."""
        return _state_signature(self._slot_template())

    def compatible_state(self, state: Pytree) -> bool:
        """True when ``state`` (a parked batch-1 KV slice) fits this engine's
        slots exactly — the failover slot-shape compatibility check."""
        try:
            sig = _state_signature(state)
        except TypeError:        # foreign object: not adoptable
            return False
        return sig == self.slot_signature()

    def _move_bytes(self, sess: Session) -> dict[str, int]:
        """The ``bytes`` a park or resume copies (one slot: every leaf of
        the slot template) and the ``live_bytes`` of them that hold the
        session's rows: a leaf with a sequence axis counts ``min(rows,
        max_seq) / max_seq`` of its bytes, any other leaf (recurrent state,
        ``pos``) whole."""
        rows = min(sess.prompt_len + len(sess.tokens), self.max_seq)
        total = live = 0
        for leaf in _leaves(self._slot_template()):
            n = int(leaf.nbytes)
            total += n
            live += n * rows // self.max_seq \
                if _has_seq_axis(tuple(leaf.shape), self.max_seq) else n
        return {"bytes": total, "live_bytes": live}

    def _cache_xattr(self, sid: int) -> dict[str, Any]:
        return {"engine": self.node, "size": self.slot_bytes(), "sid": sid}

    def _touch(self, sess: Session) -> None:
        # _clock remembers the newest tick THIS engine issued — park_idle
        # measures staleness against the engine's own latest activity
        self._clock = sess.last_active = next(ServingEngine._CLOCK)

    # ------------------------------------------------------------ admission
    def can_admit(self) -> bool:
        return bool(self._free_slots)

    def parked_sids(self) -> list[int]:
        return [s.sid for s in self.sessions.values()
                if not s.done and s.slot is None]

    def submit(self, prompt: list[int], extras: dict | None = None) -> int:
        """Prefill a prompt into a free slot; returns session id."""
        if not self._free_slots:
            raise RuntimeError("engine full")
        slot = self._free_slots.pop()
        sid = next(ServingEngine._SID)
        first, fresh, dt = self.backend.prefill(self.params, prompt, extras)
        # measured prefill cost — the router prices migrations with this
        self.prefill_seconds = (dt if self.prefill_seconds is None
                                else 0.5 * self.prefill_seconds + 0.5 * dt)
        self.prefills += 1
        # copy the single-session state into this slot of the pooled state
        self.state = self.backend.write_slot(self.state, fresh, slot)
        sess = Session(sid=sid, slot=slot, prompt_len=len(prompt),
                       tokens=[first])
        self.sessions[sid] = sess
        self._slotted[sid] = sess
        self._touch(sess)
        if self.store is not None:
            # live session: a correctly-SIZED placeholder pinned in the top
            # tier — eviction and tier_report() must account the real bytes
            self.store.put(_cache_name(sid),
                           KVSlice(None, self.slot_bytes()), loc=self.node,
                           xattr=self._cache_xattr(sid))
        self._sanitize_check()
        return sid

    # ------------------------------------------------------ park / resume
    def park(self, sid: int) -> None:
        """Evict an idle session from its engine slot into the storage
        hierarchy: the KV slice moves to ``idle_tier`` (burst buffer), the
        slot frees up for another session. The session is NOT finished — a
        later :meth:`resume` re-hydrates it without a prefill."""
        if self.store is None:
            raise RuntimeError("parking sessions requires a LocStore")
        s = self.sessions[sid]
        if s.done:
            raise RuntimeError(f"session {sid} already finished")
        if s.slot is None:
            return                                   # already parked
        with obs.span("engine.park") as sp:
            if sp.on:
                sp.set(sid=sid, **self._move_bytes(s))
            state = self.backend.read_slot(self.state, self._slot_template(),
                                           s.slot)
            self.store.put(_cache_name(sid),
                           KVSlice(state, self.slot_bytes()), loc=self.node,
                           tier=self.idle_tier, xattr=self._cache_xattr(sid))
            self._free_slots.append(s.slot)
            s.slot = None
            self._slotted.pop(sid, None)
            self.parks += 1
        self._sanitize_check()

    def park_lru(self) -> int | None:
        """Park the least-recently-active slotted session (to make room).
        Returns its sid, or None when no session can be parked."""
        if not self._slotted or self.store is None:
            return None
        victim = min(self._slotted.values(), key=lambda s: s.last_active)
        self.park(victim.sid)
        return victim.sid

    def park_idle(self, max_idle: int) -> list[int]:
        """Park every session idle for more than ``max_idle`` activity ticks
        (the serving loop's idle-demotion sweep). Returns parked sids."""
        out = []
        for s in list(self._slotted.values()):
            if not s.done and self._clock - s.last_active > max_idle:
                self.park(s.sid)
                out.append(s.sid)
        return out

    def adopt(self, sid: int, *, prompt_len: int, tokens: list[int]) -> bool:
        """Take over a session parked by a FAILED engine: register it here
        and re-hydrate it from the surviving store replica — the cross-engine
        failover that replaces a full re-prefill. With a free slot the
        session resumes immediately; on a saturated engine it stays PARKED
        (a parked session needs no slot — the next follow-up resumes it).
        Returns False (nothing registered) when the stored slice is missing,
        still a live-session placeholder, or shaped for an incompatible
        engine."""
        if self.store is None or not self.store.exists(_cache_name(sid)):
            return False
        if sid in self.sessions:
            raise RuntimeError(f"session {sid} already lives on engine "
                               f"{self.node}")
        value, _ = self.store.get(_cache_name(sid))   # metadata read
        if not isinstance(value, KVSlice) or value.state is None \
                or not self.compatible_state(value.state):
            return False
        self.sessions[sid] = Session(sid=sid, slot=None,
                                     prompt_len=prompt_len,
                                     tokens=list(tokens))
        if self._free_slots:
            self.resume(sid)
        else:
            # no capacity right now: the session stays parked here — re-home
            # the cache metadata so the router routes its next turn to us
            p = self.store.stat(_cache_name(sid))
            p.xattr.update(self._cache_xattr(sid))
            self.store.loc.record(_cache_name(sid), p)
        return True

    def resume(self, sid: int) -> bool:
        """Bring a parked session back into a slot WITHOUT re-prefilling:
        the store promotes the KV slice back to the top tier and the engine
        writes it into a free slot. Returns True if a re-hydration happened
        (False: the session was already live)."""
        s = self.sessions[sid]
        if s.done:
            raise RuntimeError(f"session {sid} already finished")
        if s.slot is not None:
            self._touch(s)
            return False
        if not self._free_slots:
            raise RuntimeError("engine full")
        with obs.span("engine.resume") as sp:
            if sp.on:
                sp.set(sid=sid, **self._move_bytes(s))
            value, _ = self.store.get(_cache_name(sid), at=self.node)
            if not isinstance(value, KVSlice) or value.state is None:
                raise RuntimeError(f"session {sid} has no parked KV state")
            slot = self._free_slots.pop()
            self.state = self.backend.write_slot(self.state, value.state,
                                                 slot)
            s.slot = slot
            self._slotted[sid] = s
            self._touch(s)
            self.resumes += 1
            self.rehydrates += 1
            # live again: swap the stored slice back to a sized placeholder
            # in the top tier (the authoritative KV is in the engine slot now)
            self.store.put(_cache_name(sid), KVSlice(None, self.slot_bytes()),
                           loc=self.node, xattr=self._cache_xattr(sid))
        self._sanitize_check()
        return True

    # ---------------------------------------------------------------- decode
    def step(self) -> dict[int, int]:
        """One decode step for every live session; returns {sid: new_token}."""
        with obs.span("engine.step") as sp:
            live = [s for s in self._slotted.values() if not s.done]
            if sp.on:
                sp.set(live=len(live), slots=self.max_batch)
            if not live:
                return {}
            tokens = np.zeros((self.max_batch, 1), np.int32)
            for s in live:
                tokens[s.slot, 0] = s.tokens[-1]
            arg, self.state = self.backend.decode(self.params, self.state,
                                                  tokens)
            self.steps += 1
            out: dict[int, int] = {}
            for s in live:
                tok = int(arg[s.slot])
                s.tokens.append(tok)
                out[s.sid] = tok
                self._touch(s)
                if tok == self.eos_id or \
                        s.prompt_len + len(s.tokens) >= self.max_seq - 1:
                    self.finish(s.sid)
            self._sanitize_check()
            return out

    def finish(self, sid: int) -> list[int]:
        s = self.sessions[sid]
        if not s.done:
            s.done = True
            if s.slot is not None:
                self._free_slots.append(s.slot)
                s.slot = None
            self._slotted.pop(sid, None)
            if self.store is not None:
                self.store.delete(_cache_name(sid))
            self._sanitize_check()
        return s.tokens

    def generate(self, prompt: list[int], max_new: int = 16) -> list[int]:
        sid = self.submit(prompt)
        while not self.sessions[sid].done and \
                len(self.sessions[sid].tokens) < max_new:
            self.step()
        self.finish(sid)
        return self.sessions[sid].tokens[:max_new]


def _has_seq_axis(shape: tuple, max_seq: int) -> bool:
    """Whether a slot leaf of ``shape`` has a sequence axis: in every
    family's layout it follows the batch axis (size 1 in a slot) and is
    not the last axis."""
    return any(a == 1 and b == max_seq
               for a, b in zip(shape[:-2], shape[1:-1]))


def _write_slot(pooled: Pytree, single: Pytree, slot: int) -> Pytree:
    """Insert a batch-1 decode state into slot ``slot`` of the pooled state,
    IN PLACE (the pooled state is returned; it holds the same tensors).

    Every state leaf layout puts batch right after the stacked layer dims; we
    detect the batch dim as the first axis whose size == 1 in ``single`` but
    differs in ``pooled``."""

    def ins(p, s):
        if p.shape == s.shape:   # max_batch == 1: the single state IS the slot
            return p.copy_(s)
        axis = next(i for i, (a, b) in enumerate(zip(p.shape, s.shape))
                    if a != b and b == 1)
        p.narrow(axis, slot, 1).copy_(s)
        return p

    return _tree_map(ins, pooled, single)


def _read_slot(pooled: Pytree, template: Pytree, slot: int) -> Pytree:
    """Extract slot ``slot`` of the pooled state as a batch-1 state — the
    exact inverse of :func:`_write_slot` (``template`` is any batch-1 state,
    used only for its shapes). The slice is a COPY: a view would be
    overwritten by the next in-place decode step, and a parked slice must
    keep the state it was parked with."""

    def ext(p, s):
        if p.shape == s.shape:   # max_batch == 1: the pooled state IS the slot
            return p.clone()
        axis = next(i for i, (a, b) in enumerate(zip(p.shape, s.shape))
                    if a != b and b == 1)
        return p.narrow(axis, slot, 1).clone()

    return _tree_map(ext, pooled, template)


# the ``kind`` attribute of a ``router.follow_up`` span
_KIND_CODE = {"hit_live": 0, "hit_parked": 1, "migrate": 2}


class Router:
    """Location-, tier- and pressure-aware request router (paper layer 3).

    ``engine_for(session_id)`` queries the location service for the node
    holding the session's KV cache. A locality hit is only taken when the
    holder can actually serve it: a session still in a slot is free to
    continue; a *parked* session needs a slot and a promotion, so the router
    prices the resume (tier media time via ``hierarchy.bw`` — the cluster
    view's ``tier_gbps`` — plus the demotions the promotion will cause at the
    engine's measured tier pressure, ``store.tier_report(node=...)``) against
    a migrate-and-re-prefill on the best other engine (its *measured*
    ``prefill_seconds``), and falls through when migrating is cheaper
    (``locality_evictions``). New sessions go to the least-loaded engine with
    a free slot; when every slot in the cluster is taken, the router parks
    the least-recently-active session somewhere (``allow_park``) instead of
    raising "engine full".
    """

    def __init__(self, engines: list[ServingEngine], store: LocStore, *,
                 prefetch: PrefetchEngine | None = None,
                 config: ServingConfig | None = None,
                 allow_park: bool | None = None) -> None:
        if config is None:
            config = ServingConfig(
                allow_park=True if allow_park is None else allow_park)
        elif allow_park is not None:
            raise TypeError("Router: pass config= OR allow_park=, not both")
        self.config = config
        self.engines = {e.node: e for e in engines}
        self.store = store
        self.prefetch = prefetch
        self.allow_park = config.allow_park
        self.locality_hits = 0
        self.locality_misses = 0
        self.locality_evictions = 0   # hit engine full/saturated: migrated
        self.migrations = 0
        self.warmups = 0
        self.failover_resumes = 0     # sessions re-hydrated across engines
        self.failover_lost = 0        # sessions needing a fresh prefill
        self.failover_deferred = 0    # durable slices parked-unhomed, waiting
        # for a compatible join_engine
        self.engine_joins = 0
        self.rebalanced_sessions = 0
        # sid -> (prompt_len, tokens) of sessions whose durable slice
        # survived a failover but had no compatible home at the time
        self._unhomed: dict[int, tuple[int, list[int]]] = {}
        # cross-engine invariant checks after route/failover/join transitions
        if config.sanitize is None:
            from repro_torch.analysis.sanitize import env_enabled
            self._sanitize = env_enabled()
        else:
            self._sanitize = bool(config.sanitize)

    def _sanitize_check(self) -> None:
        if self._sanitize:
            from repro_torch.analysis import sanitize as _san
            _san.check_router(self)

    # ------------------------------------------------------------ cost model
    def _path_seconds(self, p: Placement, kv: float, dst: int) -> float:
        """Seconds to move ``kv`` bytes from the nearest replica of ``p`` to
        node ``dst`` over the cluster network. Zero when a replica already
        sits on ``dst`` or when the store has no real topology attached
        (flat / ``None`` keeps the legacy media-only pricing bit-identical).
        """
        topo = getattr(self.store, "topology", None)
        if topo is None or topo.flat or not p.nodes or dst in p.nodes:
            return 0.0
        bw = max(topo.link_gbps(src, dst) for src in p.nodes)
        if bw == float("inf"):
            return 0.0
        if bw <= 0.0:
            return float("inf")
        return kv / bw

    def _resume_cost(self, eng: ServingEngine, name: str) -> float:
        """Seconds to bring a parked session's KV back into the holder's top
        tier: media read of the tier it is parked in + top-tier write, plus —
        when the engine is saturated — the park of a victim session and the
        demotions the promotion causes under top-tier pressure. When the
        store carries a real :class:`ClusterTopology`
        and no replica lives on the engine's node, the network hop from the
        nearest replica is charged too (a cross-spine resume is not free)."""
        hier = self.store.hierarchy
        p = self.store.stat(name)
        kv = float(p.xattr.get("size", 0.0))
        tier = p.tier_on(eng.node)
        cost = hier.media_seconds(kv, tier) + hier.media_seconds(kv, hier.top)
        cost += self._path_seconds(p, kv, eng.node)
        idle_tier = hier.normalize(eng.idle_tier)
        if not eng.can_admit():
            # a victim session must be parked first (top read + idle write)
            cost += (hier.media_seconds(kv, hier.top)
                     + hier.media_seconds(kv, idle_tier))
        top_used = self.store.tier_used(eng.node, hier.top)
        if top_used + kv > hier.capacity(hier.top):
            # promotion at pressure: the store will demote someone else
            cost += hier.media_seconds(kv, idle_tier)
        return cost

    def _migrate_cost(self, exclude: ServingEngine) -> float:
        """Seconds to re-prefill on the best other engine with a free slot,
        using each engine's measured prefill time (inf until one exists —
        never migrate onto an engine we know nothing about)."""
        costs = [e.prefill_seconds
                 for e in self.engines.values()
                 if e is not exclude and e.can_admit()
                 and e.prefill_seconds is not None]
        return min(costs) if costs else float("inf")

    # -------------------------------------------------------------- routing
    def engine_for(self, sid: int | None = None) -> ServingEngine:
        passed_over: ServingEngine | None = None
        if sid is not None and self.store.exists(_cache_name(sid)):
            node = self.store.getxattr(_cache_name(sid), "engine")
            eng = self.engines.get(node)
            sess = eng.sessions.get(sid) if eng is not None else None
            if sess is not None and not sess.done:
                if sess.slot is not None:
                    self.locality_hits += 1      # live in a slot: free
                    return eng
                # parked: needs a slot. Full + no parkable victim, or a
                # migrate priced cheaper than the promotion -> fall through.
                can_serve = (eng.can_admit()
                             or (self.allow_park and bool(eng._slotted)))
                if can_serve and (self.config.resume_bias
                                  * self._resume_cost(eng, _cache_name(sid))
                                  <= self._migrate_cost(eng)):
                    self.locality_hits += 1
                    return eng
                self.locality_evictions += 1
                passed_over = eng                # the decision was to migrate
        self.locality_misses += sid is not None
        free = [e for e in self.engines.values()
                if e.can_admit() and e is not passed_over]
        if not free:
            if self.allow_park:
                # park the least-recently-active session cluster-wide
                candidates = [e for e in self.engines.values() if e._slotted]
                if candidates:
                    eng = min(candidates, key=lambda e: min(
                        s.last_active for s in e._slotted.values()))
                    eng.park_lru()
                    return eng
            raise RuntimeError("all engines full")
        return max(free, key=lambda e: len(e._free_slots))

    def ensure_active(self, eng: ServingEngine, sid: int) -> bool:
        """Make a routed-to session live in a slot (parking a victim if the
        engine is full). Returns True if a parked session was re-hydrated."""
        sess = eng.sessions[sid]
        if sess.slot is not None:
            return False
        if not eng.can_admit():
            if not self.allow_park or eng.park_lru() is None:
                raise RuntimeError("engine full")
        return eng.resume(sid)

    def route(self, sid: int | None = None) -> RouteDecision:
        """The typed routing decision for one turn: which engine, which kind
        of hit, without side effects beyond what ``engine_for`` does (park a
        cluster-wide LRU victim to make room). ``follow_up`` executes it."""
        eng = self.engine_for(sid)
        if sid is None:
            return RouteDecision(engine=eng, sid=-1, kind="new")
        sess = eng.sessions.get(sid)
        if sess is not None and not sess.done:
            kind = "hit_live" if sess.slot is not None else "hit_parked"
            return RouteDecision(engine=eng, sid=sid, kind=kind)
        return RouteDecision(engine=eng, sid=sid, kind="migrate")

    def follow_up(self, sid: int, history: list[int]) -> RouteDecision:
        """Route one follow-up turn end-to-end. On a locality hit the session
        is resumed in place (no prefill); otherwise it migrates: the old
        engine drops it and the target re-prefills ``history``. Returns a
        :class:`RouteDecision` — ``decision.sid`` changes on a migration."""
        with obs.span("router.follow_up") as sp:
            d = self.route(sid)
            if sp.on:
                sp.set(sid=sid, kind=_KIND_CODE[d.kind])
            eng = d.engine
            if d.kind in ("hit_live", "hit_parked"):
                resumed = self.ensure_active(eng, sid)
                self._sanitize_check()
                return dataclasses.replace(d, resumed=resumed)
            # migration: the cache holder (if any) discards its copy
            for e in self.engines.values():
                s = e.sessions.get(sid)
                if s is not None and not s.done:
                    e.finish(sid)
            if sid in self._unhomed:
                # a deferred failover session re-prefilled before any
                # compatible engine joined: its parked-unhomed slice is
                # superseded
                del self._unhomed[sid]
                if self.store.exists(_cache_name(sid)):
                    self.store.delete(_cache_name(sid))
            self.migrations += 1
            if not eng.can_admit():  # engine_for made room already unless flat
                raise RuntimeError("engine full")
            new_sid = eng.submit(history)
            self._sanitize_check()
            return dataclasses.replace(d, sid=new_sid, prefilled=True)

    # -------------------------------------------------------------- failover
    def fail_engine(self, node: int) -> FailoverReport:
        """Handle the death of one engine node, cross-layer.

        The storage layer takes the atomic hit first (``store.drop_node``:
        forget the node's replicas, cancel its in-flight flushes, release its
        pins), then every non-finished session of the dead engine is triaged:

        * **parked, replica survived** (another node or a real PFS copy — the
          durability policy's doing): re-homed onto a surviving engine whose
          slot shape matches, *without* a prefill — into a slot when one is
          free, otherwise still parked (the next follow-up resumes it);
        * **live in a slot** (the authoritative KV was engine memory) or
          **parked inside the durability window** (sole replica died):
          reported ``lost`` — the caller re-prefills from conversation
          history if it wants the session back.
        """
        eng = self.engines.pop(node, None)
        if eng is None:
            raise KeyError(f"no engine on node {node}")
        drop = self.store.drop_node(node)
        resumed: list[int] = []
        lost: list[int] = []
        deferred: list[int] = []
        for sid, sess in list(eng.sessions.items()):
            if sess.done:
                continue
            sess.done = True              # the home engine is gone either way
            name = _cache_name(sid)
            value: KVSlice | None = None
            if sess.slot is None and self.store.exists(name):
                v, _ = self.store.get(name)             # metadata read
                if isinstance(v, KVSlice) and v.state is not None:
                    value = v
            target: ServingEngine | None = None
            if value is not None:
                # surviving engine with a matching slot shape, cheapest KV
                # move from the surviving replica first (under a real
                # topology; the term is a constant 0.0 otherwise so the
                # order reduces to most-free-slots), then most free slots —
                # a full engine is still a valid home: the session can
                # stay parked there, so capacity never forfeits a
                # surviving durable replica
                p = self.store.stat(name)
                kv = float(p.xattr.get("size", 0.0))
                target = next(
                    (cand for cand in sorted(self.engines.values(),
                                             key=lambda e:
                                             (self._path_seconds(p, kv,
                                                                 e.node),
                                              -len(e._free_slots)))
                     if cand.compatible_state(value.state)), None)
            if target is not None and target.adopt(
                    sid, prompt_len=sess.prompt_len, tokens=sess.tokens):
                resumed.append(sid)
                self.failover_resumes += 1
            elif value is not None:
                # the slice is durable and loadable in principle — no
                # *currently registered* engine matches (possibly none is
                # left at all). Deleting it would forfeit a prefill's worth
                # of work the durability policy just paid to keep: park it
                # unhomed and let the next compatible join_engine adopt it.
                deferred.append(sid)
                self.failover_deferred += 1
                self._unhomed[sid] = (sess.prompt_len, list(sess.tokens))
            else:
                lost.append(sid)
                self.failover_lost += 1
                if self.store.exists(name):
                    # only unusable slices land here: a live-session
                    # placeholder (state=None) whose authoritative KV died
                    # in the engine's slot memory
                    self.store.delete(name)
        self._sanitize_check()
        return FailoverReport(node=node, resumed=tuple(resumed),
                              lost=tuple(lost), drop=drop,
                              deferred=tuple(deferred))

    # ------------------------------------------------------------ membership
    def join_engine(self, node: int, engine: ServingEngine, *,
                    rebalance: bool = True) -> EngineJoinReport:
        """Admit a new engine node, cross-layer (the arrival half of
        :meth:`fail_engine`).

        The storage layer joins first (``store.join_node``: clear the failed
        mark, reopen default placement, publish the ``join_node`` event),
        then the engine registers for routing, adopts every parked-unhomed
        session whose deferred slice its slots can load (the other half of
        the ``failover_deferred`` contract), and — unless ``rebalance=False``
        — pulls parked sessions off saturated survivors to level load
        (:meth:`rebalance_parked`). Cold-start pricing (params load) is the
        trace driver's job: the router only decides placement."""
        if node in self.engines:
            raise ValueError(f"node {node} already has an engine")
        if engine.node != node:
            raise ValueError(f"engine is bound to node {engine.node}, "
                             f"asked to join as {node}")
        if engine.store is not self.store:
            raise ValueError("joining engine must share the router's store")
        join = self.store.join_node(node)
        self.engines[node] = engine
        adopted: list[int] = []
        for sid, (prompt_len, tokens) in sorted(self._unhomed.items()):
            name = _cache_name(sid)
            if not self.store.exists(name):
                del self._unhomed[sid]       # slice vanished: nothing to adopt
                continue
            value, _ = self.store.get(name)             # metadata read
            if not isinstance(value, KVSlice) or value.state is None \
                    or not engine.compatible_state(value.state):
                continue                     # wait for a matching engine
            if engine.adopt(sid, prompt_len=prompt_len, tokens=tokens):
                del self._unhomed[sid]
                adopted.append(sid)
                self.failover_resumes += 1
        rebalanced = (tuple(self.rebalance_parked(engine))
                      if rebalance else ())
        self.engine_joins += 1
        self._sanitize_check()
        return EngineJoinReport(node=node, adopted=tuple(adopted),
                                rebalanced=rebalanced, join=join)

    def rebalance_parked(self, target: ServingEngine, *,
                         max_sessions: int | None = None) -> list[int]:
        """Move parked sessions from the most-loaded engines onto ``target``
        until parked load is level (each engine at the cluster-wide mean) —
        zero re-prefill: the KV slice moves through the store, decode
        continues bit-identically. Least-recently-active sessions move
        first (they are the least likely to be resumed where they are).
        When the target cannot slot an adoptee immediately, its slice is
        additionally replicated onto the target node's idle tier so the
        eventual resume is node-local. Returns moved sids."""
        others = [e for e in self.engines.values() if e is not target]
        if not others:
            return []
        donors = {e: sorted(e.parked_sids(),
                            key=lambda s, e=e: e.sessions[s].last_active,
                            reverse=True)
                  for e in others}
        total = (sum(len(v) for v in donors.values())
                 + len(target.parked_sids()))
        fair = total // len(self.engines)
        want = fair - len(target.parked_sids())
        if max_sessions is not None:
            want = min(want, max_sessions)
        moved: list[int] = []
        while want > 0:
            donor = max(others, key=lambda e: (len(donors[e]), -e.node))
            if len(donors[donor]) <= fair:
                break                        # everyone is at (or under) fair
            sid = donors[donor].pop()        # least-recently-active first
            sess = donor.sessions.get(sid)
            name = _cache_name(sid)
            if sess is None or sess.done or sess.slot is not None \
                    or not self.store.exists(name) or sid in target.sessions:
                continue
            value, _ = self.store.get(name)             # metadata read
            if not isinstance(value, KVSlice) or value.state is None \
                    or not target.compatible_state(value.state):
                continue
            del donor.sessions[sid]
            if not target.adopt(sid, prompt_len=sess.prompt_len,
                                tokens=sess.tokens):
                donor.sessions[sid] = sess   # restore the registration
                continue
            if target.sessions[sid].slot is None:
                # adopted parked (target saturated): stage a local replica
                # so the eventual resume/warm reads node-local bytes
                self.store.replicate(name, [target.node],
                                     tier=target.idle_tier)
            moved.append(sid)
            self.rebalanced_sessions += 1
            want -= 1
        return moved

    def warm(self, sid: int) -> bool:
        """Promote a parked session's KV back toward the top tier ahead of
        its next turn (the serving analogue of the proactive prefetch) — the
        predictive-warming driver (``repro.serve.traffic``) calls this ahead
        of each predicted follow-up. With a :class:`PrefetchEngine` attached
        the promotion runs on its background thread; without one it happens
        synchronously in the store (wall-clock-free — the trace driver models
        the media time itself). No-op for unknown, finished, or live-in-slot
        sessions, and for slices whose only replica is off-node (remote/other
        node): those resume through the normal ``get(at=...)`` path."""
        name = _cache_name(sid)
        if not self.store.exists(name):
            return False
        node = self.store.getxattr(name, "engine")
        eng = self.engines.get(node)
        sess = eng.sessions.get(sid) if eng is not None else None
        if sess is None or sess.done or sess.slot is not None:
            return False
        p = self.store.stat(name)
        if not p.resident_on(node):
            # off-node-only slice: a warm cannot help — both paths must
            # agree (the prefetch path used to count these as warmups,
            # making the stat depend on whether a PrefetchEngine happened
            # to be attached)
            return False
        if self.prefetch is not None:
            self.prefetch.submit(name, node, tier=self.store.hierarchy.top)
            self.warmups += 1
            return True
        if p.tier_on(node) != self.store.hierarchy.top:
            self.store.promote(name, node, tier=self.store.hierarchy.top)
        self.warmups += 1
        return True
