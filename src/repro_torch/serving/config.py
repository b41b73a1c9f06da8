"""One config surface for the serving stack: ``ServingConfig``.

Nine PRs of organic growth left serving configuration spread over ~15
``RGL_*`` env vars, per-engine kwargs, and ``launch.serve`` CLI flags with
ad-hoc precedence.  ``ServingConfig`` consolidates all of it into one
frozen dataclass — decode arena, retrieval cache, admission/prefetch,
paged-KV/prefix-share, speculative decode, fault tolerance, router, and
the online-mutation tier — with ONE documented precedence rule:

    explicit kwarg  >  RGL_* environment variable  >  built-in default

Resolution model: a field value of ``None`` means "not specified here".
:meth:`ServingConfig.resolve` overlays explicit (non-None) kwargs onto a
base config, then :meth:`ServingConfig.finalize` fills every remaining
env-backed ``None`` from its ``RGL_*`` variable (or the built-in default)
and validates.  :meth:`ServingConfig.from_env` is the no-kwargs resolver.
Fields whose default is *derived from other fields* (``kv_block_size``,
``kv_pool_blocks``, ``prefetch_depth``, ``draft_window``,
``replica_depth``) may legitimately stay ``None`` after finalize; the
consuming layer derives them exactly as before.

``RAGServeEngine(config=...)``, the replica router (reference only so far)
and ``repro_torch.launch.serve`` are built on this; the engines' historical
kwargs keep working as a deprecation shim (they become the explicit-kwarg
layer of the same resolution).

Env var -> field map (see the README table):

========================  =======================  ====================
field                     env var                  default
========================  =======================  ====================
prefetch                  RGL_PREFETCH             False
admission                 RGL_ADMISSION            "wave"
spec_decode               RGL_SPEC_DECODE          False
draft_window              RGL_DRAFT_WINDOW         4 (engine-derived)
paged_kv                  RGL_PAGED_KV             False
kv_block_size             RGL_KV_BLOCK             auto (engine-derived)
prefix_share              RGL_PREFIX_SHARE         False
cache_ttl                 RGL_CACHE_TTL            None (no expiry)
retrieval_timeout_s       RGL_RETRIEVAL_TIMEOUT    None (no timeout)
max_retries               RGL_RETRIES              0
retry_backoff_s           RGL_RETRY_BACKOFF        0.0
degraded_mode             RGL_DEGRADED             True
max_pending               RGL_MAX_PENDING          0 (unbounded)
shed_policy               RGL_SHED_POLICY          "reject"
default_deadline_s        RGL_DEADLINE             None (no deadline)
mutation                  RGL_MUTATION             False
compact_every             RGL_COMPACT_EVERY        0 (manual compaction)
========================  =======================  ====================
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional


def env_flag(name: str) -> bool:
    """Truthy env toggle: only explicit affirmative values enable."""
    return os.environ.get(name, "").lower() in ("1", "true", "on", "yes")


def _env_float(name: str) -> Optional[float]:
    """Optional float env knob; empty/unset means None, junk raises (a typo
    must not silently disable a fault-tolerance deadline)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def _degraded_default() -> bool:
    """``RGL_DEGRADED`` env toggle, default ON: degraded-mode admission is
    part of the graceful ladder, so only an explicit falsy value disables
    it (the opposite polarity of ``env_flag``)."""
    return os.environ.get("RGL_DEGRADED", "").lower() not in (
        "0", "false", "off", "no"
    )


def _shed_policy_default() -> str:
    raw = os.environ.get("RGL_SHED_POLICY", "reject").lower()
    if raw not in ("reject", "evict-oldest"):
        raise ValueError(
            f"RGL_SHED_POLICY={raw!r}: expected 'reject' or 'evict-oldest'"
        )
    return raw


def _admission_default() -> str:
    """``RGL_ADMISSION`` env default ("wave").  Invalid values raise — the
    two schedules produce identical outputs, so a typo would otherwise run
    silently in the wrong mode."""
    raw = os.environ.get("RGL_ADMISSION", "wave").lower()
    if raw not in ("wave", "continuous"):
        raise ValueError(
            f"RGL_ADMISSION={raw!r}: expected 'wave' or 'continuous'"
        )
    return raw


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Every serving knob in one frozen value (see module docstring).

    ``None`` in an env-backed field means "resolve from the environment";
    after :meth:`finalize` those fields are concrete.  ``None`` in a
    derived field (``draft_window``, ``kv_block_size``, ``kv_pool_blocks``,
    ``prefetch_depth``, ``replica_depth``) means "let the consuming layer
    derive it" and may persist.
    """

    # -- decode arena -----------------------------------------------------
    slots: int = 8
    cache_len: int = 512
    eos_id: Optional[int] = None
    spec_decode: Optional[bool] = None
    draft_window: Optional[int] = None
    paged_kv: Optional[bool] = None
    kv_block_size: Optional[int] = None
    kv_pool_blocks: Optional[int] = None
    prefix_share: Optional[bool] = None
    # -- retrieval cache --------------------------------------------------
    cache_capacity: int = 256
    quant_eps: float = 1e-3
    cache_policy: str = "lru"
    cache_ttl: Optional[float] = None
    region_bucket: int = 32
    mutation_flush: str = "region"
    # -- admission / prefetch ---------------------------------------------
    prefetch: Optional[bool] = None
    prefetch_depth: Optional[int] = None
    admission: Optional[str] = None
    # -- fault tolerance / overload control -------------------------------
    retrieval_timeout_s: Optional[float] = None
    max_retries: Optional[int] = None
    retry_backoff_s: Optional[float] = None
    degraded_mode: Optional[bool] = None
    max_pending: Optional[int] = None
    shed_policy: Optional[str] = None
    default_deadline_s: Optional[float] = None
    # -- replica router ---------------------------------------------------
    replicas: int = 1
    failover: bool = True
    replica_depth: Optional[int] = None
    health_window: int = 8
    trip_threshold: int = 3
    cooldown_steps: int = 8
    # -- online mutation --------------------------------------------------
    mutation: Optional[bool] = None
    compact_every: Optional[int] = None

    _ENV_BOOL = (("spec_decode", "RGL_SPEC_DECODE"),
                 ("paged_kv", "RGL_PAGED_KV"),
                 ("prefix_share", "RGL_PREFIX_SHARE"),
                 ("prefetch", "RGL_PREFETCH"),
                 ("mutation", "RGL_MUTATION"))

    @classmethod
    def from_env(cls) -> "ServingConfig":
        """The single env resolver: built-in defaults overlaid with every
        set ``RGL_*`` variable."""
        return cls().finalize()

    @classmethod
    def resolve(cls, config: Optional["ServingConfig"] = None,
                **overrides) -> "ServingConfig":
        """Apply the precedence rule: explicit kwarg > env > default.

        ``overrides`` entries that are ``None`` count as "not specified"
        (they fall through to ``config``, then env, then default) —
        exactly the contract the engines' historical kwargs had.
        """
        base = config if config is not None else cls()
        explicit = {k: v for k, v in overrides.items() if v is not None}
        unknown = set(explicit) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise TypeError(
                f"unknown ServingConfig field(s): {sorted(unknown)}"
            )
        return dataclasses.replace(base, **explicit).finalize()

    def finalize(self) -> "ServingConfig":
        """Fill env-backed ``None`` fields from ``RGL_*`` and validate."""
        kw = {}
        for field, env in self._ENV_BOOL:
            if getattr(self, field) is None:
                kw[field] = env_flag(env)
        if self.admission is None:
            kw["admission"] = _admission_default()
        else:
            adm = str(self.admission).lower()
            if adm not in ("wave", "continuous"):
                raise ValueError(
                    f"admission={adm!r}: expected 'wave' or 'continuous'"
                )
            kw["admission"] = adm
        if self.shed_policy is None:
            kw["shed_policy"] = _shed_policy_default()
        else:
            shed = str(self.shed_policy).lower()
            if shed not in ("reject", "evict-oldest"):
                raise ValueError(
                    f"shed_policy={shed!r}: expected 'reject' or "
                    f"'evict-oldest'"
                )
            kw["shed_policy"] = shed
        if self.draft_window is None and os.environ.get("RGL_DRAFT_WINDOW"):
            kw["draft_window"] = _env_int("RGL_DRAFT_WINDOW", None)
        if self.kv_block_size is None and os.environ.get("RGL_KV_BLOCK"):
            kw["kv_block_size"] = _env_int("RGL_KV_BLOCK", None)
        if self.cache_ttl is None:
            kw["cache_ttl"] = _env_float("RGL_CACHE_TTL")
        if self.retrieval_timeout_s is None:
            kw["retrieval_timeout_s"] = _env_float("RGL_RETRIEVAL_TIMEOUT")
        if self.max_retries is None:
            kw["max_retries"] = _env_int("RGL_RETRIES", 0)
        if self.retry_backoff_s is None:
            kw["retry_backoff_s"] = _env_float("RGL_RETRY_BACKOFF") or 0.0
        if self.degraded_mode is None:
            kw["degraded_mode"] = _degraded_default()
        if self.max_pending is None:
            kw["max_pending"] = _env_int("RGL_MAX_PENDING", 0)
        max_pending = kw.get("max_pending", self.max_pending)
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        if self.default_deadline_s is None:
            kw["default_deadline_s"] = _env_float("RGL_DEADLINE")
        if self.compact_every is None:
            kw["compact_every"] = _env_int("RGL_COMPACT_EVERY", 0)
        if self.mutation_flush not in ("region", "all"):
            raise ValueError(
                f"mutation_flush must be 'region' or 'all', got "
                f"{self.mutation_flush!r}"
            )
        return dataclasses.replace(self, **kw) if kw else self
