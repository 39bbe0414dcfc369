"""The composable policy-layer protocol and the stack that composes it.

Four PRs of scenario axes (spot, multi-region, burstable credits,
price-pressure autoscaling) originally accreted as boolean flags on
``EvaScheduler``, each axis interleaving its catalog transforms, keep-test
modifiers and pressure handlers through ``core/scheduler.py``.  This
module is the decomposition: one axis = one ``PolicyLayer``, and a
``PolicyStack`` owns ordering and composition so axes stack declaratively
instead of branching imperatively.

Hook points (all optional — the base class is the inert identity layer):

===================  =======================================================
hook                 what it composes
===================  =======================================================
``plan_catalog``     catalog-snapshot transforms, generalizing the existing
                     ``at → credit_priced → forecast_catalog`` chain.  Each
                     layer declares a ``catalog_phase``: ``SNAPSHOT``
                     transforms re-price from base costs (``catalog.at``,
                     ``forecast_catalog`` — they do *not* commute with the
                     planning stage and must come first), ``PLANNING``
                     transforms derive effective planning prices from the
                     snapshot (``credit_priced``).  The stack validates the
                     documented order at construction and folds
                     left-to-right, returning ``(raw, cat)`` — the snapshot
                     (billing-accurate) and planning catalogs.
``pre_round``        admission / job-population edits, run before anything
                     is priced: a layer may strip held jobs' tasks from the
                     round's view and return force-admitted job ids (routed
                     through the scheduler's forced-partial path).
``keep_bonus``       per-instance keep-test slack; the stack sums every
                     layer's bonus (addition commutes, so keep-test layers
                     may appear in any order).
``type_mask``        standing pack restriction (e.g. a region pin); masks
                     from all layers are AND-combined once at bind time.
``region_caps``      per-region Algorithm-1 pack budgets (first non-None
                     wins; only the multi-region layer provides one).
``evacuate``         live instances to force out of the config this round
                     (spot revocations, credit drains); the union triggers
                     one shared forced partial reconfiguration.
``drain_mask``       extra type restriction applied only to that forced
                     partial (e.g. credit drains escape to steady types).
``refine``           post-pass config refinement (the multi-region
                     arbitrage rewrite), folded in stack order.
``on_pressure``      one ``PressureSignal`` handler replacing the three
                     parallel spot/credit/deadline wirings.
===================  =======================================================
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from .pressure import PressureSignal

# catalog-pipeline phases: SNAPSHOT transforms re-price from base costs and
# must precede PLANNING transforms, which derive effective planning prices
# from the snapshot (applying `at` after `credit_priced` would silently
# discard the credit adjustment — the documented order is load-bearing).
SNAPSHOT = 0
PLANNING = 1


class PolicyLayer:
    """One scenario axis, expressed against the hook points above.

    The base class is the identity on every hook, so a layer only
    implements the hooks its axis needs.  ``bind`` attaches the layer to
    its scheduler (catalog, D̂ estimator, migration-delay scale);
    ``post_bind`` runs after the whole stack is bound, when the combined
    ``PolicyStack.mask`` is available (admission layers thread it into
    their controllers).
    """

    name = "layer"
    catalog_phase: Optional[int] = None  # SNAPSHOT / PLANNING / None
    needs_runtime_estimates = False

    def bind(self, scheduler) -> None:
        self.sched = scheduler

    def post_bind(self, stack: "PolicyStack") -> None:
        pass

    # -- catalog pipeline ----------------------------------------------------
    def plan_catalog(self, catalog, view, d_hat_s: float):
        return catalog

    # -- job population ------------------------------------------------------
    def pre_round(self, view, d_hat_s: float) -> Tuple[object, Set[int]]:
        """Return ``(view, resumed)``: the possibly-filtered round view and
        the job ids force-admitted this round."""
        return view, set()

    # -- keep test / packing modifiers ---------------------------------------
    def keep_bonus(self, raw, cat, view) -> Optional[Callable]:
        """Optional ``(type_index, task_ids) -> $/h`` keep-test slack."""
        return None

    def type_mask(self, catalog) -> Optional[np.ndarray]:
        return None

    def region_caps(self, catalog) -> Optional[tuple]:
        return None

    # -- pressure reactions --------------------------------------------------
    def evacuate(self, raw, view) -> Set[int]:
        """Live instance ids to force out of this round's config."""
        return set()

    def drain_mask(self, raw, view) -> Optional[np.ndarray]:
        """Extra type restriction for the forced partial (drains only)."""
        return None

    def on_pressure(self, signal: PressureSignal) -> None:
        pass

    # -- post-pass -----------------------------------------------------------
    def refine(self, config, view, cat):
        return config

    # -- observability -------------------------------------------------------
    def summary(self) -> dict:
        """Per-layer counters merged into benchmark result rows."""
        return {}


class PolicyStack:
    """Ordered composition of policy layers.

    Owns the one composition rule that is *not* commutative — the catalog
    pipeline (``SNAPSHOT`` before ``PLANNING``, validated here) — and folds
    every other hook across layers in stack order (keep bonuses sum, masks
    AND, evacuation sets union, refinements chain).
    """

    def __init__(self, layers: Sequence[PolicyLayer] = ()):
        self.layers: Tuple[PolicyLayer, ...] = tuple(layers)
        seen_planning = False
        for layer in self.layers:
            if layer.catalog_phase == SNAPSHOT and seen_planning:
                raise ValueError(
                    f"layer '{layer.name}' re-prices from base costs and "
                    "must precede planning transforms (the documented "
                    "snapshot -> planning order: at/forecast before "
                    "credit_priced)")
            if layer.catalog_phase == PLANNING:
                seen_planning = True
        self._snapshot = [la for la in self.layers
                          if la.catalog_phase == SNAPSHOT]
        self._planning = [la for la in self.layers
                          if la.catalog_phase == PLANNING]
        self.mask: Optional[np.ndarray] = None
        self.caps: Optional[tuple] = None
        # provenance (set at bind): which layers contributed to the combined
        # mask, and which layer's region_caps won — read by the decision
        # trace, never by planning itself
        self.mask_layers: Tuple[str, ...] = ()
        self.caps_layer: Optional[str] = None

    # -- container protocol --------------------------------------------------
    def __iter__(self) -> Iterator[PolicyLayer]:
        return iter(self.layers)

    def __len__(self) -> int:
        return len(self.layers)

    def get(self, key) -> Optional[PolicyLayer]:
        """Layer by name (str) or class; None when absent."""
        for layer in self.layers:
            if isinstance(key, str):
                if layer.name == key:
                    return layer
            elif isinstance(layer, key):
                return layer
        return None

    def has(self, key) -> bool:
        return self.get(key) is not None

    def describe(self) -> str:
        return " + ".join(layer.name for layer in self.layers) or "(empty)"

    @property
    def needs_runtime_estimates(self) -> bool:
        return any(la.needs_runtime_estimates for la in self.layers)

    # -- binding -------------------------------------------------------------
    def bind(self, scheduler) -> None:
        for layer in self.layers:
            layer.bind(scheduler)
        mask: Optional[np.ndarray] = None
        mask_layers: List[str] = []
        for layer in self.layers:
            m = layer.type_mask(scheduler.catalog)
            if m is not None:
                m = np.asarray(m, dtype=bool)
                mask = m if mask is None else (mask & m)
                mask_layers.append(layer.name)
        self.mask = mask
        self.mask_layers = tuple(mask_layers)
        self.caps = None
        self.caps_layer = None
        for layer in self.layers:
            caps = layer.region_caps(scheduler.catalog)
            if caps is not None:
                self.caps = caps
                self.caps_layer = layer.name
                break
        for layer in self.layers:
            layer.post_bind(self)

    # -- hook folds ----------------------------------------------------------
    def pre_round(self, view, d_hat_s: float) -> Tuple[object, Set[int]]:
        resumed: Set[int] = set()
        for layer in self.layers:
            view, r = layer.pre_round(view, d_hat_s)
            resumed |= r
        return view, resumed

    def plan(self, catalog, view, d_hat_s: float):
        """Fold the catalog pipeline; returns ``(raw, cat)`` — the snapshot
        (billing-accurate, post-``at``) and planning (effective-price)
        catalogs."""
        cur = catalog
        for layer in self._snapshot:
            cur = layer.plan_catalog(cur, view, d_hat_s)
        raw = cur
        for layer in self._planning:
            cur = layer.plan_catalog(cur, view, d_hat_s)
        return raw, cur

    def keep_bonus_parts(self, raw, cat, view) -> List[Tuple[str, Callable]]:
        """Per-layer ``(layer_name, fn)`` keep-slack contributions this
        round — each layer's hook invoked exactly once, so the decision
        trace can decompose the summed bonus without re-running hooks."""
        parts: List[Tuple[str, Callable]] = []
        for layer in self.layers:
            fn = layer.keep_bonus(raw, cat, view)
            if fn is not None:
                parts.append((layer.name, fn))
        return parts

    @staticmethod
    def combine(fns: Sequence[Callable]) -> Optional[Callable]:
        """Sum keep-bonus callables (bit-identical to the single-fn case:
        ``sum`` over one term adds exact float zero)."""
        fns = list(fns)
        if not fns:
            return None
        if len(fns) == 1:
            return fns[0]
        return lambda k, tids: sum(f(k, tids) for f in fns)

    def keep_bonus(self, raw, cat, view) -> Optional[Callable]:
        return self.combine(
            fn for _, fn in self.keep_bonus_parts(raw, cat, view))

    def evacuate(self, raw, view) -> Set[int]:
        evac: Set[int] = set()
        for layer in self.layers:
            evac |= layer.evacuate(raw, view)
        return evac

    def drain_mask(self, raw, view) -> Optional[np.ndarray]:
        """Type mask for a forced partial: the standing mask AND any drain
        restrictions — falling back to the standing mask when the combined
        restriction would leave no feasible type."""
        extra: Optional[np.ndarray] = None
        for layer in self.layers:
            m = layer.drain_mask(raw, view)
            if m is not None:
                m = np.asarray(m, dtype=bool)
                extra = m if extra is None else (extra & m)
        if extra is None:
            return self.mask
        if self.mask is not None:
            extra = extra & self.mask
        return extra if extra.any() else self.mask

    def refine(self, config, view, cat):
        for layer in self.layers:
            config = layer.refine(config, view, cat)
        return config

    def on_pressure(self, signal: PressureSignal) -> None:
        for layer in self.layers:
            layer.on_pressure(signal)

    def summary(self) -> dict:
        out: dict = {}
        for layer in self.layers:
            out.update(layer.summary())
        return out
