"""The closed loop: drift fires -> retrain -> canary -> audited promote
(port of lightgbm_tpu/continual/loop.py: the same policy kernel, the same
events in the same order).

Two layers, separated so the decision logic is a fast unit test and the
daemon is plumbing:

* `decide(...)` -- the PURE policy kernel. Inputs are the `drift_psi`
  watchdog fire count, the immutable `PolicyState` carried between
  calls, and the clock; output is the action ("refit" | "continue" |
  "wait") plus the next state. No I/O, no globals.

* `ContinualLoop` -- the daemon around it: polls the watchdog fire
  counter (`telemetry.watchdogs.fired()`), runs the caller-supplied
  `retrain(action)` when the kernel says to act, checkpoints the
  result, publishes it into the `ModelRegistry` (on the registry's
  device: the card unless it was made with ``device="cpu"``), deploys
  it as a canary through the `CanaryRouter`, and records the audited
  outcome (promote / rollback) once the router's gate -- counters, SLO,
  watchdogs and the labelled-feedback AUC check -- resolves it. One
  episode in flight at a time: a pending canary blocks the next
  retrain, so a flapping drift monitor cannot stack deploys.

Policies (`continual_policy`):

* ``refit``    -- every fire answers with a leaf-value refit (one
  ``index_add_`` over the leaves on the card, structure untouched).
* ``continue`` -- every fire answers with an `init_model` warm-start
  top-up (new trees on history + fresh rows: the training path, with
  its hand kernels).
* ``auto``     -- refit first; if drift STAYS high (another fire lands
  after the refit episode, within `reset_after_s`), escalate to a
  continuation -- structure drift that leaf values cannot absorb. A
  quiet period resets the escalation back to refit.

Every step of an episode lands in the event stream (`continual_fire` ->
`continual_retrain` -> `continual_deploy` -> `continual_promote` /
`continual_rollback`). A retrain that raises is logged, evented and
answered with "retrain_failed", as in the JAX package: the loop
survives it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from ..telemetry import counters as telem_counters
from ..telemetry import events as telem_events
from ..telemetry import watchdogs as telem_watchdogs
from ..utils import log

ACTIONS = ("refit", "continue", "wait")
POLICIES = ("refit", "continue", "auto")


@dataclasses.dataclass(frozen=True)
class PolicyState:
    """Everything `decide` carries between calls: how many watchdog
    fires have been answered, what the last action was and when."""
    handled_fires: int = 0
    last_action: Optional[str] = None
    last_action_t: float = float("-inf")


def decide(policy: str, fires: int, state: PolicyState, now: float,
           cooldown_s: float, reset_after_s: Optional[float] = None):
    """The policy kernel: (action, next_state). Pure — same inputs,
    same answer.

    * no unanswered fire → wait;
    * inside the cooldown window after the last action → wait (the
      retrained model needs traffic before drift evidence means
      anything new);
    * otherwise act per policy. `auto` escalates refit → continue when
      the new fire lands within `reset_after_s` (default 10×cooldown)
      of the last action — drift that survived a refit needs new
      trees — and de-escalates back to refit after a quiet period.
    """
    if policy not in POLICIES:
        raise ValueError(
            f"continual_policy must be one of {'/'.join(POLICIES)}, "
            f"got {policy!r}")
    if fires <= state.handled_fires:
        return "wait", state
    if now - state.last_action_t < cooldown_s:
        return "wait", state
    if policy == "auto":
        window = (10.0 * cooldown_s if reset_after_s is None
                  else reset_after_s)
        escalate = (state.last_action is not None
                    and (now - state.last_action_t) <= window)
        action = "continue" if escalate else "refit"
    else:
        action = policy
    return action, PolicyState(handled_fires=fires, last_action=action,
                               last_action_t=now)


class ContinualLoop:
    """Policy daemon closing drift detection onto deployment.

    `retrain(action)` is supplied by the embedder (`task=continual`
    wires the CLI data path) and returns a Booster (or a model-file
    path / model string -- anything `ModelRegistry.load` accepts).
    """

    def __init__(self, registry, router, retrain: Callable[[str], object],
                 *, policy: str = "auto", cooldown_s: float = 30.0,
                 canary_weight: float = 0.2, poll_s: float = 1.0,
                 reset_after_s: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        if policy not in POLICIES:
            raise ValueError(
                f"continual_policy must be one of {'/'.join(POLICIES)}, "
                f"got {policy!r}")
        self.registry = registry
        self.router = router
        self.retrain = retrain
        self.policy = policy
        self.cooldown_s = float(cooldown_s)
        self.canary_weight = float(canary_weight)
        self.poll_s = float(poll_s)
        self.reset_after_s = reset_after_s
        self.checkpoint_dir = checkpoint_dir
        self._time = time_fn
        self.state = PolicyState()
        self.episodes = []            # resolved episode dicts, bounded
        self._inflight: Optional[dict] = None
        self._ckpt_n = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- episode machinery ----------------------------------------------
    def _fires(self) -> int:
        return int(telem_watchdogs.fired().get("drift_psi", 0))

    def _checkpoint(self, model) -> object:
        """Persist the retrained model (with its drift sidecar) when a
        checkpoint directory is configured; registry.load takes the live
        object either way, so persistence never gates deployment."""
        if self.checkpoint_dir is None or not hasattr(model, "save_model"):
            return model
        import os
        from ..serving import drift as serve_drift
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self._ckpt_n += 1
        path = os.path.join(self.checkpoint_dir,
                            f"continual_{self._ckpt_n:04d}.txt")
        model.save_model(path)
        baseline = getattr(getattr(model, "_gbdt", model),
                           "_drift_baseline", None)
        if isinstance(baseline, dict):
            serve_drift.save_baseline(baseline, path + ".drift.json")
        return model

    def _resolve_inflight(self) -> Optional[str]:
        """Poll the router's verdict on the episode's canary. The
        router already audited the transition with its gate snapshot;
        here we only close the episode and keep score."""
        ep = self._inflight
        if ep is None:
            return None
        version = ep["version"]
        if self.router.canary == version:
            return "pending"
        promoted = self.router.stable == version
        ep["outcome"] = "promoted" if promoted else "rolled_back"
        ep["resolved_t"] = self._time()
        self._inflight = None
        self.episodes.append(ep)
        del self.episodes[:-50]
        if promoted:
            telem_counters.incr("continual_promotions")
            telem_events.emit("continual_promote", version=version,
                              action=ep["action"],
                              episode=ep["episode"])
            log.info("continual: %s promoted (episode %d, %s)",
                     version, ep["episode"], ep["action"])
        else:
            telem_counters.incr("continual_rollbacks")
            telem_events.emit("continual_rollback", version=version,
                              action=ep["action"],
                              episode=ep["episode"])
            log.warning("continual: %s rolled back (episode %d, %s)",
                        version, ep["episode"], ep["action"])
        return ep["outcome"]

    def step(self, now: Optional[float] = None) -> str:
        """One poll of the loop; returns what happened ("wait",
        "pending", "promoted", "rolled_back", "deployed"). The daemon
        thread calls this every `poll_s`; tests and chip_smoke drive it
        synchronously for determinism."""
        resolved = self._resolve_inflight()
        if resolved == "pending":
            return "pending"
        now = self._time() if now is None else now
        fires = self._fires()
        action, next_state = decide(self.policy, fires, self.state, now,
                                    self.cooldown_s, self.reset_after_s)
        if action == "wait":
            return resolved or "wait"
        self.state = next_state
        episode = len(self.episodes) + 1
        telem_events.emit("continual_fire", action=action, fires=fires,
                          policy=self.policy, episode=episode)
        log.info("continual: drift fire #%d -> %s (policy %s)", fires,
                 action, self.policy)
        t0 = self._time()
        try:
            model = self.retrain(action)
        except Exception as exc:   # noqa: BLE001 — loop must survive
            log.warning("continual: retrain (%s) failed: %s", action, exc)
            telem_events.emit("continual_retrain", action=action,
                              episode=episode, error=str(exc))
            return "retrain_failed"
        telem_counters.incr("continual_retrains")
        model = self._checkpoint(model)
        version = self.registry.load(model)
        telem_events.emit("continual_retrain", action=action,
                          episode=episode, version=version,
                          seconds=round(self._time() - t0, 3))
        if self.router.stable is None:
            # nothing to canary against — first deploy becomes stable
            self.router.set_stable(version)
            telem_events.emit("continual_deploy", version=version,
                              weight=1.0, episode=episode, stable=True)
            return "deployed"
        self.router.deploy(version, weight=self.canary_weight)
        telem_events.emit("continual_deploy", version=version,
                          weight=self.canary_weight, episode=episode)
        self._inflight = {"episode": episode, "action": action,
                          "version": version, "fired_t": now,
                          "deployed_t": self._time()}
        return "deployed"

    # -- daemon ----------------------------------------------------------
    def start(self) -> "ContinualLoop":
        if self._thread is not None:
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(self.poll_s):
                try:
                    self.step()
                except Exception as exc:   # noqa: BLE001 — keep polling
                    log.warning("continual: loop step failed: %s", exc)

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="lgbm-torch-continual")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def snapshot(self) -> dict:
        ep = self._inflight
        return {"policy": self.policy, "cooldown_s": self.cooldown_s,
                "handled_fires": self.state.handled_fires,
                "last_action": self.state.last_action,
                "inflight": dict(ep) if ep else None,
                "episodes": [dict(e) for e in self.episodes[-10:]]}
