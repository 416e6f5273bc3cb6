"""Deterministic fault injection + transient-collective retry (port of
lightgbm_tpu/resilience/faults.py: the same grammar, and the same seeded
``np.random.RandomState`` draws, so one spec poisons the same rows in
both packages).

Production training has failure modes the happy path never exercises:
corrupted gradients out of a flaky objective/transport, collectives that
time out mid-allreduce, a predictor that stalls long enough to blow
request deadlines. This layer makes every one of them *reproducible* so
the guards (resilience/sentries.py), checkpoints (resilience/
checkpoint.py) and the serving batcher's timeout path can be tested
deterministically — the same role chaos harnesses play around the
reference's distributed learners (the socket linkers' retry loops,
linkers_socket.cpp), but seedable and in-process.

Fault spec grammar (env ``LGBM_TPU_FAULT_SPEC`` or ``faults.install``):

    clause[;clause...]

    nan_grad@iter=7[,frac=0.01]     poison `frac` of the gradient lanes
                                    with NaN at boosting iteration 7
                                    (one-shot: fires at most once)
    inf_grad@iter=7[,frac=0.01]     same with +inf
    nan_grad@p=0.05                 poison with probability p each
                                    iteration (seeded)
    fail_collective@n=2             fail the first 2 collective calls
                                    with TransientCollectiveError, then
                                    heal (exercises the retry path)
    fail_collective@p=0.1           fail each collective call with
                                    probability p (seeded)
    kill_rank@iter=3[,code=137]     hard-exit THIS process (os._exit)
                                    at boosting iteration 3 — the chaos
                                    verb behind the two-process kill
                                    harness (install the spec only in
                                    the victim rank's environment)
    preempt@iter=3                  arm the graceful-preemption flag
                                    (resilience/preempt.py) at boosting
                                    iteration 3 — deterministic stand-in
                                    for a SIGTERM eviction notice: the
                                    loop checkpoints and exits 76
    fail_request@version=v2,n=5     fail the first 5 serving batches
                                    answered by model version v2 (omit
                                    version= to hit all versions; p=
                                    for probabilistic) — the router-
                                    chaos verb driving canary demotion
    delay_ms=50                     sleep 50 ms at every fault site
                                    (collectives + serving flush)
    seed=123                        RNG seed for probabilistic clauses

Hook sites: ``GBDT._compute_gradients`` (gradient boundary: the rows
are chosen on the host and written on the tensor's own device),
``engine.train``'s iteration boundary (``kill_point``, ``sleep_point``).
``run_collective`` (bounded exponential backoff under an optional
deadline) and ``request_point`` have no caller in the port until its
multi-GPU and serving layers land; they are ported whole so those
layers find them. All hooks are no-ops costing one attribute read when
no plan is installed.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..telemetry import bundle as telem_bundle
from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events
from ..telemetry import recorder as telem
from ..utils import log

__all__ = ["TransientCollectiveError", "CollectiveTimeout",
           "EpochDesyncError", "FaultPlan",
           "install", "clear", "active_plan", "run_collective",
           "sleep_point", "kill_point", "request_point", "jittered_delay",
           "set_collective_timeout_ms", "collective_timeout_ms",
           "set_epoch", "current_epoch", "iteration_fence", "fence_active"]

_GLOBAL_KNOBS = ("seed", "delay_ms")
_KNOWN = ("nan_grad", "inf_grad", "fail_collective", "kill_rank",
          "fail_request", "preempt")


class TransientCollectiveError(RuntimeError):
    """A collective failed in a way worth retrying (injected here; the
    real-world analogs are preempted hosts and dropped DCN links)."""


class EpochDesyncError(RuntimeError):
    """Two ranks met inside a collective while on DIFFERENT boosting
    iterations. Exchanging payloads across an epoch skew silently mixes
    stale histograms into a fresh iteration — this typed error (both
    epochs named) is what a collective's framing raises instead. Not
    transient: a desync means the retry/rollback choreo-
    graphy itself diverged, so blind retry would re-fail identically."""

    def __init__(self, local_epoch: int, remote_epoch: int, rank: int):
        self.local_epoch = int(local_epoch)
        self.remote_epoch = int(remote_epoch)
        self.rank = int(rank)
        super().__init__(
            f"collective epoch desync: local iteration epoch "
            f"{self.local_epoch} but rank {self.rank} sent epoch "
            f"{self.remote_epoch}")


class CollectiveTimeout(RuntimeError):
    """A collective dispatch exceeded its deadline
    (``dist_collective_timeout_ms``). Deliberately NOT a
    TransientCollectiveError: a deadline miss means a peer is likely
    dead or wedged, and re-entering the same collective would block the
    survivor again — the caller must consult a supervision layer instead
    of retrying blindly."""


class _Clause:
    __slots__ = ("name", "args", "fired")

    def __init__(self, name: str, args: Dict[str, str]):
        self.name = name
        self.args = args
        self.fired = False

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"_Clause({self.name}, {self.args}, fired={self.fired})"


def parse_spec(spec: str):
    """-> (clauses, seed, delay_ms). Raises ValueError on bad grammar."""
    clauses: List[_Clause] = []
    seed, delay_ms = 0, 0.0
    for part in str(spec).split(";"):
        part = part.strip()
        if not part:
            continue
        if "@" in part:
            name, _, argstr = part.partition("@")
            name = name.strip()
            args = {}
            for kv in argstr.split(","):
                if not kv.strip():
                    continue
                if "=" not in kv:
                    raise ValueError(f"bad fault arg {kv!r} in {part!r}")
                k, _, v = kv.partition("=")
                args[k.strip()] = v.strip()
            if name not in _KNOWN:
                raise ValueError(f"unknown fault {name!r}")
            clauses.append(_Clause(name, args))
        elif "=" in part:
            k, _, v = part.partition("=")
            k = k.strip()
            if k == "seed":
                seed = int(v)
            elif k == "delay_ms":
                delay_ms = float(v)
            else:
                raise ValueError(f"unknown fault knob {k!r}")
        else:
            raise ValueError(f"bad fault clause {part!r}")
    return clauses, seed, delay_ms


class FaultPlan:
    """A parsed spec plus the seeded RNG and per-site call counters.

    One plan instance persists across the run so one-shot clauses fire
    exactly once and `n=`-bounded clauses count globally.
    """

    def __init__(self, spec: str, seed: Optional[int] = None):
        self.spec = spec
        self.clauses, spec_seed, self.delay_ms = parse_spec(spec)
        self.seed = spec_seed if seed is None else int(seed)
        self.rng = np.random.RandomState(self.seed % (2 ** 31 - 1))
        self.collective_calls = 0
        self._request_fail_counts: Dict[int, int] = {}
        self.events: List[str] = []     # fired faults, for tests/forensics

    @property
    def has_gradient_faults(self) -> bool:
        """True when the plan poisons gradients. The fused device step
        computes gradients in-program where the host cannot reach them,
        so GBDT drops to the generic path while such a plan is active —
        the harness tests the guards, not the fused fast path."""
        return any(c.name in ("nan_grad", "inf_grad") for c in self.clauses)

    # -- gradient boundary ---------------------------------------------
    def inject_gradients(self, grad, hess, iteration: int):
        """Possibly poison (grad, hess) for this boosting iteration.
        Arrays are (K, N) torch tensors; the poisoned rows are drawn on the
        host and written on the tensor's device (a new tensor) — only when
        a fault actually fires."""
        for c in self.clauses:
            if c.name not in ("nan_grad", "inf_grad"):
                continue
            if "iter" in c.args:
                if c.fired or iteration != int(c.args["iter"]):
                    continue
            elif "p" in c.args:
                if self.rng.rand() >= float(c.args["p"]):
                    continue
            else:
                continue
            c.fired = True
            frac = float(c.args.get("frac", 0.01))
            val = np.inf if c.name == "inf_grad" else np.nan
            grad = self._poison(grad, frac, val)
            self.events.append(f"{c.name}@iter={iteration}")
            telem_events.emit("fault", fault=c.name, iteration=iteration,
                              frac=frac)
            log.warning("fault injection: %s at iteration %d (frac=%g)",
                        c.name, iteration, frac)
        return grad, hess

    def _poison(self, grad, frac: float, val: float):
        n = grad.shape[-1]
        k = max(1, int(n * frac))
        rows = self.rng.choice(n, k, replace=False)
        g = grad.clone()
        g[..., torch.as_tensor(rows, device=g.device)] = val
        return g

    # -- collective / serving boundaries --------------------------------
    def before_collective(self, site: str) -> None:
        """Called before each collective dispatch: may sleep, may raise
        TransientCollectiveError."""
        self.maybe_delay(site)
        call_n = self.collective_calls
        self.collective_calls += 1
        for c in self.clauses:
            if c.name != "fail_collective":
                continue
            if "n" in c.args:
                if call_n >= int(c.args["n"]):
                    continue
            elif "p" in c.args:
                if self.rng.rand() >= float(c.args["p"]):
                    continue
            else:
                continue
            self.events.append(f"fail_collective@{site}#{call_n}")
            telem_events.emit("fault", fault="fail_collective", site=site,
                              call=call_n)
            raise TransientCollectiveError(
                f"injected collective failure at {site} (call {call_n})")

    def maybe_delay(self, site: str) -> None:
        if self.delay_ms > 0:
            self.events.append(f"delay@{site}")
            time.sleep(self.delay_ms / 1e3)

    def before_request(self, version: str) -> None:
        """Called by the serving batcher before executing a batch for
        `version`: may raise to fail every request in that batch — the
        deterministic error spike the canary demotion gate watches for."""
        for idx, c in enumerate(self.clauses):
            if c.name != "fail_request":
                continue
            want = c.args.get("version")
            if want and want != str(version):
                continue
            if "n" in c.args:
                fired = self._request_fail_counts.get(idx, 0)
                if fired >= int(c.args["n"]):
                    continue
                self._request_fail_counts[idx] = fired + 1
            elif "p" in c.args:
                if self.rng.rand() >= float(c.args["p"]):
                    continue
            # bare fail_request@version=v: fail every matching batch
            self.events.append(f"fail_request@{version}")
            telem_events.emit("fault", fault="fail_request",
                              version=str(version))
            raise RuntimeError(
                f"injected request failure for version {version}")

    # -- process-death boundary -----------------------------------------
    def kill_code(self, iteration: int) -> Optional[int]:
        """Exit code to die with at this boosting iteration, or None.
        Pure decision logic so tests can pin it without dying; the
        actual os._exit lives in module-level `kill_point`."""
        for c in self.clauses:
            if c.name != "kill_rank" or c.fired:
                continue
            if "iter" not in c.args or iteration != int(c.args["iter"]):
                continue
            c.fired = True
            self.events.append(f"kill_rank@iter={iteration}")
            return int(c.args.get("code", 137))
        return None

    def preempt_at(self, iteration: int) -> bool:
        """True when a ``preempt@iter=`` clause fires at this boosting
        iteration (one-shot). Pure decision logic; arming the actual
        flag (resilience/preempt.py) happens in `kill_point`."""
        for c in self.clauses:
            if c.name != "preempt" or c.fired:
                continue
            if "iter" not in c.args or iteration != int(c.args["iter"]):
                continue
            c.fired = True
            self.events.append(f"preempt@iter={iteration}")
            return True
        return False


# -- global plan -------------------------------------------------------
_plan: Optional[FaultPlan] = None
_env_plan: Optional[FaultPlan] = None
_env_spec: Optional[str] = None


def install(spec: Optional[str], seed: Optional[int] = None
            ) -> Optional[FaultPlan]:
    """Install a process-wide fault plan (None/'' clears). Returns it."""
    global _plan
    _plan = FaultPlan(spec, seed) if spec else None
    return _plan


def clear() -> None:
    install(None)


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else one parsed (once) from
    LGBM_TPU_FAULT_SPEC, else None."""
    global _env_plan, _env_spec
    if _plan is not None:
        return _plan
    spec = os.environ.get("LGBM_TPU_FAULT_SPEC", "")
    if not spec:
        return None
    if spec != _env_spec:
        _env_spec = spec
        _env_plan = FaultPlan(spec)
    return _env_plan


def sleep_point(site: str) -> None:
    """Pure-delay fault site (serving flush, eval loops)."""
    plan = active_plan()
    if plan is not None:
        plan.maybe_delay(site)


def request_point(version: str) -> None:
    """Request-failure fault site (`fail_request@` clauses); the serving
    batcher calls this with the resolved model version per flush."""
    plan = active_plan()
    if plan is not None:
        plan.before_request(version)


def kill_point(iteration: int) -> None:
    """Process-death fault site (`kill_rank@iter=` clauses). The engine
    loop calls this at the top of each boosting iteration; the victim
    dies with os._exit so no atexit/teardown runs — exactly how a
    preempted or OOM-killed rank disappears."""
    plan = active_plan()
    if plan is None:
        return
    if plan.preempt_at(iteration):
        # deterministic eviction notice: same flag, same downstream
        # path (checkpoint + exit 76) as a real SIGTERM
        from . import preempt
        telem_events.emit("fault", fault="preempt", iteration=iteration)
        preempt.arm(f"fault:preempt@iter={iteration}")
    code = plan.kill_code(iteration)
    if code is not None:
        telem_events.emit("fault", fault="kill_rank", iteration=iteration,
                          code=code)
        telem_events.flush()
        # the victim's last act: freeze its world before os._exit skips
        # every destructor (LGBM_TPU_BUNDLE_DIR unset = no-op)
        telem_bundle.maybe_capture("kill_rank", iteration=iteration,
                                   exit_code=code)
        log.warning("fault injection: kill_rank at iteration %d "
                    "(os._exit(%d))", iteration, code)
        os._exit(code)


def _retry_budget():
    return (int(os.environ.get("LGBM_TPU_COLLECTIVE_RETRIES", 3)),
            float(os.environ.get("LGBM_TPU_RETRY_BASE_MS", 10.0)) / 1e3)


# -- iteration epoch + fence --------------------------------------------
# The boosting loop stamps the current iteration here, for a collective
# layer to carry in every payload header so ranks meeting inside a
# collective can verify they are on the SAME iteration (EpochDesyncError
# otherwise). -1 = outside any loop.
_epoch = -1
_fence_depth = 0


def set_epoch(n: int) -> None:
    """Stamp the iteration-epoch sequence number (engine/cli loops)."""
    global _epoch
    _epoch = int(n)


def current_epoch() -> int:
    return _epoch


class iteration_fence:
    """Context manager marking "this code runs inside one boosting
    iteration whose caller can retry the WHOLE iteration from captured
    pre-iteration state". While active, ``run_collective`` re-raises
    TransientCollectiveError immediately instead of retrying the single
    dispatch blind — a mid-iteration transient leaves partially-applied
    per-dispatch state (histogram shards on some ranks, not others), so
    the iteration-level rollback (scores + RNG) is the only retry that
    is actually consistent."""

    def __enter__(self):
        global _fence_depth
        _fence_depth += 1
        return self

    def __exit__(self, *exc):
        global _fence_depth
        _fence_depth -= 1
        return False


def fence_active() -> bool:
    return _fence_depth > 0


def jittered_delay(delay_s: float, rng) -> float:
    """Uniform jitter in [delay/2, delay): simultaneous retriers across
    a fleet decorrelate instead of re-colliding every backoff step
    (full backoff growth is preserved — only the sleep is jittered)."""
    return float(delay_s) * (0.5 + 0.5 * float(rng.rand()))


# -- collective deadline ------------------------------------------------
# Set by a caller (or the env var below). 0 = off, which is the single-
# process default: the deadline thread costs a dispatch per collective,
# so it is strictly opt-in.
_timeout_override: Optional[float] = None


def set_collective_timeout_ms(ms: Optional[float]) -> None:
    """Install a process-wide collective deadline (None re-reads env)."""
    global _timeout_override
    _timeout_override = None if ms is None else float(ms)


def collective_timeout_ms() -> float:
    if _timeout_override is not None:
        return _timeout_override
    try:
        return float(os.environ.get("LGBM_TPU_COLLECTIVE_TIMEOUT_MS", 0))
    except ValueError:
        return 0.0


def _call_with_deadline(fn, site: str, timeout_ms: float):
    """Dispatch fn on a watchdog-timed worker thread. On deadline the
    worker is abandoned (it is blocked inside a dead collective; the
    caller is about to tear the process group down anyway) and a typed
    CollectiveTimeout is raised instead of hanging forever."""
    done = threading.Event()
    box: Dict[str, object] = {}

    def _runner():
        try:
            box["result"] = fn()
        except BaseException as exc:   # noqa: BLE001 — marshalled below
            box["error"] = exc
        finally:
            done.set()

    t = threading.Thread(target=_runner, daemon=True,
                         name=f"lgbm-tpu-collective-{site}")
    t.start()
    if not done.wait(timeout_ms / 1e3):
        telem_counters.incr("collective_timeouts")
        telem_events.emit("collective_timeout", site=site,
                          timeout_ms=timeout_ms)
        telem_bundle.maybe_capture("collective_timeout", site=site,
                                   timeout_ms=timeout_ms)
        log.warning("collective %s exceeded its %.0f ms deadline", site,
                    timeout_ms)
        raise CollectiveTimeout(
            f"collective {site} exceeded {timeout_ms:.0f} ms deadline")
    err = box.get("error")
    if err is not None:
        raise err
    return box.get("result")


def run_collective(fn, site: str = "collective",
                   retries: Optional[int] = None,
                   base_delay_s: Optional[float] = None):
    """Dispatch a host-side collective call with bounded exponential-
    backoff retry (jittered) on TransientCollectiveError, under the
    optional process-wide deadline (dist_collective_timeout_ms — a
    deadline miss raises CollectiveTimeout, which is NOT retried here).
    With no active plan and no deadline this is a plain call — zero
    overhead on the clean path. `fn` must be side-effect-free, so a
    retry is always consistent."""
    # dispatch count is forensic ground truth either way (low-frequency:
    # bootstrap, barriers, ingest — never per-split), so it does not
    # gate on an active plan or on telemetry mode
    telem_counters.incr("collective_dispatches")
    deadline_ms = collective_timeout_ms()
    plan = active_plan()
    if plan is None:
        # clean path: one recorder-gate read (a no-op context manager
        # while telemetry is off) on top of the plain call
        with telem.phase("collective"):
            if deadline_ms > 0:
                return _call_with_deadline(fn, site, deadline_ms)
            return fn()
    env_retries, env_base = _retry_budget()
    budget = env_retries if retries is None else int(retries)
    delay = env_base if base_delay_s is None else float(base_delay_s)
    attempt = 0
    while True:
        try:
            plan.before_collective(site)
            with telem.phase("collective"):
                if deadline_ms > 0:
                    return _call_with_deadline(fn, site, deadline_ms)
                return fn()
        except TransientCollectiveError as exc:
            if _fence_depth > 0:
                # epoch-fenced mode: the engine retries the iteration
                # from its captured pre-iteration state; retrying the
                # single dispatch here would race that rollback
                log.warning("transient failure at %s under an iteration "
                            "fence: aborting the iteration for "
                            "epoch-level retry (%s)", site, exc)
                raise
            attempt += 1
            telem_counters.incr("collective_retries")
            if attempt > budget:
                telem_counters.incr("collective_failures")
                log.warning("collective %s failed after %d retries", site,
                            budget)
                raise
            sleep_s = jittered_delay(delay, plan.rng)
            log.warning("transient failure at %s (attempt %d/%d): %s; "
                        "retrying in %.0f ms", site, attempt, budget, exc,
                        sleep_s * 1e3)
            time.sleep(sleep_s)
            delay = min(delay * 2.0, 1.0)
