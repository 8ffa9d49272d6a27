"""Decision-tree auto-tuning (paper §II-B3 Adjusting + §II-B4 Feedback);
port of ``repro/core/tuner.py``.

The paper's tool
1. *Impact analysis*: perturb one parameter at a time, run the proxy, and
   record each parameter's effect on each metric;
2. fits a **decision tree** on those samples;
3. *Adjusting stage*: when a metric deviates, the tree decides which
   parameter to move;
4. *Feedback stage*: re-evaluate the tuned proxy; iterate until every
   metric deviation <= tol (15% in the paper).

The CART is implemented from scratch in numpy: multi-output regression
over features = log2 of the tunable P entries of every node, targets =
the metric vector M, re-fit online as the loop observes new samples.

Elasticity priors: a ``priors`` table (:func:`repro_torch.core.priors.
elasticity_priors` over the decomposed proxy) gives the adjusting stage
analytic per-(param, metric) slopes before anything is measured.  Params
the prior covers skip their impact-analysis perturbations, and every
observation of a prior-backed pair blends in through ``(c * prior +
sum(observed)) / (c + n)`` instead of the flat 0.5/0.5 mix.
``priors=None`` is the legacy loop, and an empty table is bit-identical
to it.

Mesh-aware tuning: a ``quantize`` hook (normally :func:`repro_torch.core.
cluster.make_quantizer`'s closure over ``quantize_proxy``) is applied to
every candidate at construction, before it is encoded or evaluated, so
the tree predicts on quantized features, elasticities are learned from
quantized moves, and every scored candidate is a fixed point of the
rule.  ``qualification_rate`` (the fraction of submitted candidates that
are fixed points) certifies it; ``quantize=None`` is the legacy loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

from repro_torch.core.accuracy import compare, deviations
from repro_torch.core.motifs.base import TUNABLE_BOUNDS, get_motif
from repro_torch.core.proxy_graph import ProxyBenchmark

if TYPE_CHECKING:  # annotation only: the tuner duck-types the table
    from repro_torch.core.priors import PriorTable

# ---------------------------------------------------------------------------
# From-scratch CART (multi-output regression tree)
# ---------------------------------------------------------------------------


@dataclass
class _TreeNode:
    feature: int = -1          # -1 -> leaf
    threshold: float = 0.0
    left: Optional["_TreeNode"] = None
    right: Optional["_TreeNode"] = None
    value: Optional[np.ndarray] = None  # leaf prediction (n_outputs,)


class DecisionTree:
    """CART regression tree, variance-reduction splits, multi-output."""

    def __init__(self, max_depth: int = 4, min_samples: int = 2):
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.root: Optional[_TreeNode] = None
        self.n_features = 0
        self.n_outputs = 0

    def fit(self, X: np.ndarray, Y: np.ndarray) -> "DecisionTree":
        X = np.asarray(X, np.float64)
        Y = np.asarray(Y, np.float64)
        if Y.ndim == 1:
            Y = Y[:, None]
        self.n_features = X.shape[1]
        self.n_outputs = Y.shape[1]
        self.root = self._grow(X, Y, 0)
        return self

    def _grow(self, X, Y, depth) -> _TreeNode:
        node = _TreeNode(value=Y.mean(axis=0))
        if depth >= self.max_depth or len(X) < 2 * self.min_samples:
            return node
        base_var = Y.var(axis=0).sum()
        if base_var <= 1e-18:
            return node
        best = (None, None, 0.0)  # (feature, threshold, gain)
        for f in range(self.n_features):
            vals = np.unique(X[:, f])
            if len(vals) < 2:
                continue
            for t in (vals[:-1] + vals[1:]) / 2.0:
                m = X[:, f] <= t
                nl, nr = m.sum(), (~m).sum()
                if nl < self.min_samples or nr < self.min_samples:
                    continue
                var = (Y[m].var(axis=0).sum() * nl
                       + Y[~m].var(axis=0).sum() * nr) / len(X)
                gain = base_var - var
                if gain > best[2]:
                    best = (f, t, gain)
        if best[0] is None:
            return node
        f, t, _ = best
        m = X[:, f] <= t
        node.feature, node.threshold = f, t
        node.left = self._grow(X[m], Y[m], depth + 1)
        node.right = self._grow(X[~m], Y[~m], depth + 1)
        return node

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.root is None:
            raise RuntimeError("DecisionTree.predict called before fit(): "
                               "there is no tree to walk")
        X = np.asarray(X, np.float64)
        single = X.ndim == 1
        if single:
            X = X[None]
        out = np.stack([self._pred_one(x) for x in X])
        return out[0] if single else out

    def _pred_one(self, x) -> np.ndarray:
        node = self.root
        while node is not None and node.feature >= 0:
            node = node.left if x[node.feature] <= node.threshold else node.right
        return node.value if node is not None else np.zeros(self.n_outputs)

    def depth(self) -> int:
        def d(n):
            if n is None or n.feature < 0:
                return 0
            return 1 + max(d(n.left), d(n.right))
        return d(self.root)


# ---------------------------------------------------------------------------
# Parameter-space encoding
# ---------------------------------------------------------------------------

#: P fields the tuner may move, per node (weight always; sizes when the
#: motif lists them as tunable)
_MOVABLE = ("weight", "data_size", "chunk_size", "num_tasks",
            "batch_size", "height", "width", "channels")

_LOG_FIELDS = {"data_size", "chunk_size", "num_tasks", "batch_size",
               "height", "width", "channels", "weight"}


@dataclass(frozen=True)
class ParamRef:
    node_id: str
    field: str

    def label(self) -> str:
        return f"{self.node_id}.{self.field}"


def movable_params(pb: ProxyBenchmark) -> List[ParamRef]:
    refs: List[ParamRef] = []
    for n in pb.nodes:
        tunable = set(get_motif(n.motif).tunable)
        for f in _MOVABLE:
            if f == "weight" or f in tunable:
                refs.append(ParamRef(n.id, f))
    return refs


def encode(pb: ProxyBenchmark, refs: Sequence[ParamRef]) -> np.ndarray:
    x = []
    for r in refs:
        v = float(getattr(pb.node(r.node_id).p, r.field))
        x.append(math.log2(max(v, 1e-6)) if r.field in _LOG_FIELDS else v)
    return np.asarray(x, np.float64)


def apply_move(pb: ProxyBenchmark, ref: ParamRef,
               factor: float) -> ProxyBenchmark:
    """Multiply one parameter by `factor`, clamped to its bounds."""
    cur = float(getattr(pb.node(ref.node_id).p, ref.field))
    lo, hi = TUNABLE_BOUNDS[ref.field]
    new = min(max(cur * factor, lo), hi)
    if ref.field != "weight":
        new = int(round(new))
    return pb.with_node(ref.node_id, **{ref.field: new})


# ---------------------------------------------------------------------------
# The auto-tuner
# ---------------------------------------------------------------------------

EvalFn = Callable[[ProxyBenchmark], Dict[str, float]]
BatchEvalFn = Callable[[Sequence[ProxyBenchmark]], List[Dict[str, float]]]


@dataclass
class TuneTrace:
    """One adjust->feedback iteration record."""

    iteration: int
    moved: str
    factor: float
    worst_metric: str
    worst_dev_before: float
    worst_dev_after: float
    mean_acc: float
    accepted: bool


@dataclass
class TuneResult:
    proxy: ProxyBenchmark
    qualified: bool
    iterations: int
    final_devs: Dict[str, float]
    mean_accuracy: float
    trace: List[TuneTrace] = field(default_factory=list)
    tree_depth: int = 0
    evals: int = 0
    #: fraction of evaluated candidates that were fixed points of the
    #: tuner's quantize rule at submission: 1.0 by construction with a
    #: rule, and by convention without one
    qualification_rate: float = 1.0
    #: True when the run was seeded with an elasticity-prior table
    prior_seeded: bool = False


class DecisionTreeTuner:
    """Impact analysis -> decision tree -> adjust/feedback loop."""

    def __init__(self, evaluate: EvalFn, target: Mapping[str, float],
                 tol: float = 0.15, max_iters: int = 24,
                 impact_factor: float = 2.0, seed: int = 0,
                 batch_evaluate: Optional[BatchEvalFn] = None,
                 quantize: Optional[Callable[[ProxyBenchmark],
                                             ProxyBenchmark]] = None,
                 priors: Optional["PriorTable"] = None):
        # `evaluate` may be a plain EvalFn or a BatchEvaluator / EvalSession
        # (callable, with an `evaluate_batch` method that dedups shape
        # classes)
        if batch_evaluate is None:
            batch_evaluate = getattr(evaluate, "evaluate_batch", None)
        self.evaluate = evaluate
        self.batch_evaluate = batch_evaluate
        self.target = dict(target)
        self.tol = tol
        self.max_iters = max_iters
        self.impact_factor = impact_factor
        # candidate-rounding rule: an idempotent ProxyBenchmark ->
        # ProxyBenchmark map applied to every candidate before it is
        # encoded or evaluated.  None = the legacy path, untouched.
        self.quantize = quantize
        # None = the observed-only loop; an EMPTY table must be
        # bit-identical to None, so every prior branch below keys off an
        # actual table entry
        self.priors = priors
        # tune.impact + tune.iteration spans land on the engine's hub
        # (BatchEvaluator/EvalSession expose `.telemetry`), else on the
        # process default
        telemetry = getattr(evaluate, "telemetry", None)
        if telemetry is None:
            from repro_torch.runtime.telemetry import get_default

            telemetry = get_default()
        self.telemetry = telemetry
        self._slope_obs: Dict[Tuple[str, str], Tuple[float, int]] = {}
        self.rng = np.random.default_rng(seed)
        self.samples_X: List[np.ndarray] = []
        self.samples_Y: List[np.ndarray] = []
        self.metric_names: List[str] = sorted(self.target)
        self.tree = DecisionTree(max_depth=4)
        self.evals = 0
        # of the candidates submitted, how many were already fixed points
        # of the quantize rule
        self.submitted = 0
        self.submitted_qualified = 0

    # -- candidate rounding ---------------------------------------------------
    def _q(self, pb: ProxyBenchmark) -> ProxyBenchmark:
        return pb if self.quantize is None else self.quantize(pb)

    def _is_qualified(self, pb: ProxyBenchmark) -> bool:
        """Is ``pb`` a fixed point of the quantize rule?"""
        if self.quantize is None:
            return True
        q = self.quantize(pb)
        return q is pb or q.shape_signature() == pb.shape_signature()

    @property
    def qualification_rate(self) -> float:
        if self.submitted == 0:
            return 1.0
        return self.submitted_qualified / self.submitted

    # -- metric plumbing ----------------------------------------------------
    def _mvec(self, m: Mapping[str, float]) -> np.ndarray:
        return np.asarray([float(m.get(k, 0.0)) for k in self.metric_names])

    def _eval(self, pb: ProxyBenchmark) -> Dict[str, float]:
        return self._eval_batch([pb])[0]

    def _eval_batch(self, pbs: Sequence[ProxyBenchmark]
                    ) -> List[Dict[str, float]]:
        self.evals += len(pbs)
        self.submitted += len(pbs)
        self.submitted_qualified += sum(
            1 for pb in pbs if self._is_qualified(pb))
        if self.batch_evaluate is not None:
            return list(self.batch_evaluate(pbs))
        return [self.evaluate(pb) for pb in pbs]

    # -- impact analysis (paper: "changes one parameter each time") ---------
    def impact_analysis(self, pb: ProxyBenchmark,
                        refs: Sequence[ParamRef]) -> Dict[str, float]:
        """One-at-a-time perturbation -> signed log-log elasticities
        ``self.elasticity[(param_label, metric)]`` = d log(metric) /
        d log(param).  The base and every informative perturbation are
        submitted as ONE candidate batch.  Params a prior table covers
        skip their perturbations (the analytic slope replaces the probe),
        and measured slopes of prior-backed pairs blend in as
        observations.  Every perturbation passes the quantize rule first:
        a move it rounds back to the base, or couples with another
        feature, carries no single-param slope and is dropped before it
        costs an eval."""
        base_x = encode(pb, refs)
        covered = self.priors.covered if self.priors is not None else ()
        cands: List[Tuple[int, ProxyBenchmark, float]] = []
        for i, ref in enumerate(refs):
            if ref.label() in covered:
                continue  # the analytic prior replaces this probe
            for factor in (self.impact_factor, 1.0 / self.impact_factor):
                moved = self._q(apply_move(pb, ref, factor))
                delta = encode(moved, refs) - base_x
                dx = delta[i]
                if dx == 0.0:
                    continue  # clamped at bound, no information
                if np.any(np.abs(np.delete(delta, i)) > 1e-9):
                    continue  # other features moved: no single-param slope
                cands.append((i, moved, dx))

        with self.telemetry.span("tune.impact", candidates=len(cands) + 1,
                                 params=len(refs),
                                 skipped_by_prior=len(covered)):
            measured = self._eval_batch([pb] + [c[1] for c in cands])
            base_m = measured[0]
            self._base_m = base_m
            self._record(base_x, base_m)
            base_v = self._mvec(base_m)
            importance: Dict[str, float] = {}
            self.elasticity: Dict[Tuple[str, str], float] = {}
            if self.priors is not None:
                # with zero observations the blend is the prior itself
                self.elasticity.update(
                    {k: float(v) for k, v in self.priors.slopes.items()})
            slopes_by_ref: Dict[int, List[np.ndarray]] = {}
            for (i, moved, dx), m in zip(cands, measured[1:]):
                self._record(encode(moved, refs), m)
                mv = self._mvec(m)
                dlog = (np.log(np.abs(mv) + 1e-12)
                        - np.log(np.abs(base_v) + 1e-12))
                slopes_by_ref.setdefault(i, []).append(dlog / dx)
                delta = np.abs(mv - base_v)
                denom = np.abs(base_v) + 1e-9
                importance[refs[i].label()] = max(
                    importance.get(refs[i].label(), 0.0),
                    float((delta / denom).max()))
            for i, slopes in slopes_by_ref.items():
                slope = np.mean(slopes, axis=0)
                for j, metric in enumerate(self.metric_names):
                    key = (refs[i].label(), metric)
                    if self.priors is not None and key in self.priors.slopes:
                        for s in slopes:
                            self._observe(key, float(s[j]))
                    else:
                        self.elasticity[key] = float(slope[j])
            self._refit()
            return importance

    def _observe(self, key: Tuple[str, str], slope: float) -> None:
        """Prior-weighted online update for one (param, metric) slope:
        ``(c * prior + sum(observed)) / (c + n)``.  Only reached for keys
        the prior table holds."""
        prior = self.priors.slopes[key]
        c = self.priors.confidence
        s, n = self._slope_obs.get(key, (0.0, 0))
        s, n = s + slope, n + 1
        self._slope_obs[key] = (s, n)
        self.elasticity[key] = (c * float(prior) + s) / (c + n)

    def _record(self, x: np.ndarray, m: Mapping[str, float]) -> None:
        self.samples_X.append(x)
        self.samples_Y.append(self._mvec(m))

    def _refit(self) -> None:
        if len(self.samples_X) >= 4:
            self.tree.fit(np.stack(self.samples_X), np.stack(self.samples_Y))

    # -- adjusting stage ------------------------------------------------------
    def _predict_score(self, pb: ProxyBenchmark,
                       refs: Sequence[ParamRef]) -> float:
        """Tree-predicted deviation score for a candidate proxy."""
        pred = self.tree.predict(encode(pb, refs))
        tgt = self._mvec(self.target)
        rel = np.abs(pred - tgt) / (np.abs(tgt) + 1e-9)
        return float(rel.max() + 0.25 * rel.mean())

    def _score(self, devs: Mapping[str, float]) -> float:
        vals = list(devs.values())
        return max(vals) + 0.25 * sum(vals) / len(vals)

    def _newton_factor(self, param: str, metric: str,
                       cur: float, tgt: float) -> Optional[float]:
        """Step factor that would close metric's log-deviation, from the
        learned elasticity; None when the parameter has no leverage."""
        e = self.elasticity.get((param, metric), 0.0)
        if abs(e) < 0.02:
            return None
        need = math.log(max(abs(tgt), 1e-12)) - math.log(max(abs(cur), 1e-12))
        dlog_param = need / e
        dlog_param = min(max(dlog_param, -2.0), 2.0)  # clamp to 4x a step
        if abs(dlog_param) < 0.05:
            return None
        return 2.0 ** dlog_param

    def _explore(self, cur: ProxyBenchmark, refs: Sequence[ParamRef],
                 attempts: int = 8
                 ) -> Optional[Tuple[ProxyBenchmark, str, float, int]]:
        """Exploration fallback: a (param, factor) move that is not a
        no-op, or ``None`` when no such move exists at all.  Random draws
        first, then a deterministic sweep over every (param, factor)."""
        cur_x = encode(cur, refs)
        for _ in range(attempts):
            i = int(self.rng.integers(len(refs)))
            f = float(self.rng.choice(
                [self.impact_factor, 1.0 / self.impact_factor]))
            attempt = self._q(apply_move(cur, refs[i], f))
            if not np.array_equal(encode(attempt, refs), cur_x):
                return attempt, refs[i].label(), f, i
        for i, ref in enumerate(refs):
            for f in (self.impact_factor, 1.0 / self.impact_factor):
                attempt = self._q(apply_move(cur, ref, f))
                if not np.array_equal(encode(attempt, refs), cur_x):
                    return attempt, ref.label(), f, i
        return None

    def _online_update(self, refs: Sequence[ParamRef],
                       cur: ProxyBenchmark, cand: ProxyBenchmark,
                       cur_m: Mapping[str, float],
                       cand_m: Mapping[str, float],
                       moved_label: str, moved_idx: int) -> bool:
        """Elasticity update from one observed adjust move; True when an
        update was applied (a move of exactly the moved param's feature)."""
        delta = encode(cand, refs) - encode(cur, refs)
        dx = float(delta[moved_idx])
        others_moved = bool(np.any(np.abs(np.delete(delta, moved_idx))
                                   > 1e-9))
        if abs(dx) <= 1e-9 or others_moved:
            return False
        mv, bv = self._mvec(cand_m), self._mvec(cur_m)
        dlog = (np.log(np.abs(mv) + 1e-12)
                - np.log(np.abs(bv) + 1e-12)) / dx
        for j, metric in enumerate(self.metric_names):
            key = (moved_label, metric)
            if self.priors is not None and key in self.priors.slopes:
                self._observe(key, float(dlog[j]))
            else:
                old = self.elasticity.get(key, 0.0)
                self.elasticity[key] = 0.5 * old + 0.5 * float(dlog[j])
        return True

    @staticmethod
    def _expire_cooldowns(blacklist: Dict[Tuple[str, str], int],
                          set_this_iter) -> Dict[Tuple[str, str], int]:
        """Entries set this iteration keep their full count; everything
        else decrements and drops at zero."""
        return {k: (v if k in set_this_iter else v - 1)
                for k, v in blacklist.items()
                if k in set_this_iter or v > 1}

    def tune(self, pb: ProxyBenchmark) -> TuneResult:
        # the seed proxy is rounded first, so the whole loop lives in
        # quantized space
        pb = self._q(pb)
        refs = movable_params(pb)
        self.impact_analysis(pb, refs)

        trace: List[TuneTrace] = []
        cur = pb
        cur_m = dict(self._base_m)
        blacklist: Dict[Tuple[str, str], int] = {}  # (param, metric) -> cooldown
        by_label = {r.label(): (i, r) for i, r in enumerate(refs)}

        for it in range(self.max_iters):
            devs = deviations(self.target, cur_m, self.metric_names)
            worst_metric = max(devs, key=devs.get)
            worst = devs[worst_metric]
            if worst <= self.tol:
                break
            # one adjust->feedback move per span; the tolerance check
            # stays outside so a converged loop traces no phantom iteration
            with self.telemetry.span("tune.iteration", iteration=it,
                                     worst_metric=worst_metric,
                                     worst_dev=float(worst)) as sp:
                cur_score = self._score(devs)
                set_this_iter: set = set()

                # decision-tree stage: rank parameters by |elasticity| for
                # the deviating metric; Newton-step the best
                # non-blacklisted one
                ranked = sorted(
                    by_label,
                    key=lambda lbl: -abs(self.elasticity.get(
                        (lbl, worst_metric), 0.0)))
                cand = None
                moved_label, moved_factor, moved_idx = "", 1.0, -1
                for lbl in ranked:
                    if blacklist.get((lbl, worst_metric), 0) > 0:
                        continue
                    i, ref = by_label[lbl]
                    f = self._newton_factor(lbl, worst_metric,
                                            cur_m.get(worst_metric, 0.0),
                                            self.target[worst_metric])
                    if f is None:
                        continue
                    attempt = self._q(apply_move(cur, ref, f))
                    if np.array_equal(encode(attempt, refs),
                                      encode(cur, refs)):
                        continue  # clamped at bound (or rounded back)
                    # CART veto: skip moves the surrogate predicts harmful
                    if (len(self.samples_X) >= 8
                            and self._predict_score(attempt, refs)
                            > cur_score * 1.5):
                        blacklist[(lbl, worst_metric)] = 2
                        set_this_iter.add((lbl, worst_metric))
                        continue
                    cand, moved_label, moved_factor, moved_idx = (
                        attempt, lbl, f, i)
                    break
                if cand is None:
                    explored = self._explore(cur, refs)
                    if explored is None:
                        sp.set(exhausted=True)
                        break  # every move is a no-op
                    cand, moved_label, moved_factor, moved_idx = explored
                    sp.set(explored=True)

                cand_m = self._eval(cand)
                self._record(encode(cand, refs), cand_m)
                self._refit()
                self._online_update(refs, cur, cand, cur_m, cand_m,
                                    moved_label, moved_idx)

                cand_devs = deviations(self.target, cand_m,
                                       self.metric_names)
                accepted = self._score(cand_devs) < cur_score
                sp.set(moved=moved_label, factor=float(moved_factor),
                       accepted=accepted)
                trace.append(TuneTrace(
                    iteration=it, moved=moved_label, factor=moved_factor,
                    worst_metric=worst_metric, worst_dev_before=worst,
                    worst_dev_after=max(cand_devs.values()),
                    mean_acc=compare(self.target, cand_m,
                                     self.metric_names).mean,
                    accepted=accepted))
                if accepted:
                    cur, cur_m = cand, cand_m
                else:
                    blacklist[(moved_label, worst_metric)] = 2
                    set_this_iter.add((moved_label, worst_metric))
                blacklist = self._expire_cooldowns(blacklist, set_this_iter)

        final_devs = deviations(self.target, cur_m, self.metric_names)
        rep = compare(self.target, cur_m, self.metric_names)
        return TuneResult(
            proxy=cur,
            qualified=max(final_devs.values(), default=1.0) <= self.tol,
            iterations=len(trace),
            final_devs=final_devs,
            mean_accuracy=rep.mean,
            trace=trace,
            tree_depth=self.tree.depth(),
            evals=self.evals,
            qualification_rate=self.qualification_rate,
            prior_seeded=bool(self.priors is not None
                              and (self.priors.slopes
                                   or self.priors.covered)),
        )
