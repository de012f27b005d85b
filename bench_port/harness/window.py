"""The measured window: closed-loop episodes of a loop's driver.

Each episode resets the worlds to the spawn that set-up saved on the
device and steps them `episode_steps` times; the reset lies inside the
window and its time counts in the episode's first step. The window ends
with the first step that ends `seconds` after it began, and not before
the steps that the check samples from its first episode. Each step's wall
time is taken on the host clock, the step ended as the loop ends it.

A step fails where its world (any world of a batch) reports an overflow
that loses work: pairs, store drops, CCD, particles or dropped events.
Their counters are kept by reference and read once at each episode's
end, never at each step.

Episode 0 keeps the primary state (`keep`: harness.check.primary of the
reference's leaves) before and after the sampled steps, and the window
keeps its last, for the correctness check. In a traced run, episode 1
counts the work that the per-layer metrics' count hooks ask for (after
each step, reading once at the end), and episode 2 runs under
torch.profiler; the window lasts until episode 2 has ended."""

from __future__ import annotations

import time

import torch

from .trace import Trace
FAILED = ("overflow_pairs", "store_drops", "overflow_ccd",
          "overflow_particles", "events_dropped")


class Window:
    def __init__(self):
        self.step_s = []        # wall time of every step
        self.steps = 0
        self.failed = 0
        self.seconds = 0.0      # the window's wall time
        self.snaps = []         # (episode step, primary before, after)
        self.last = None        # the primary state the window ended with
        self.counts = {}        # metric name -> (steps, k) tensor
        self.trace = None       # Trace of the traced episode
        self.traced_steps = 0
        self.traced_s = 0.0
        self.traced_stats = {}  # counter deltas over the traced episode
        self.first_step_at = None


def _failed_steps(profiles) -> int:
    if not profiles:
        return 0
    v = torch.stack([torch.stack([getattr(p, f) for f in FAILED])
                     for p in profiles])
    return int((v.reshape(v.shape[0], -1) > 0).any(1).sum())


def _stats(st) -> dict:
    return dict(syncs=st.syncs)


def run(driver, seconds: float, episode_steps: int, snap_at=(),
        trace: bool = False, count_hooks=None, device=None,
        keep=lambda state: None) -> Window:
    """Step `driver` for `seconds` of closed-loop episodes (see module)."""
    win = Window()
    count_hooks = count_hooks or {}
    snap_at = set(snap_at)
    profiles, counted = [], {k: [] for k in count_hooks}
    prof = None
    ep = k = 0
    t_start = time.perf_counter()
    win.first_step_at = t_start
    t_prev = t_start
    while True:
        if k == 0:
            if trace and ep == 2:
                prof = _start_profiler()
                base = _stats(driver.stats)
                t_trace = time.perf_counter()
            driver.reset()
        before = driver.state
        snap = ep == 0 and k in snap_at
        if snap:
            pre = keep(before)
        driver.step()
        now = time.perf_counter()
        win.step_s.append(now - t_prev)
        t_prev = now
        win.steps += 1
        profiles.append(driver.state.profile)
        if snap:
            win.snaps.append((k, pre, keep(driver.state)))
        if trace and ep == 1:
            for name, hook in count_hooks.items():
                counted[name].append(hook(driver, before, driver.state))
        k += 1
        if k == episode_steps:
            if prof is not None:
                _sync(device)
                win.traced_s = time.perf_counter() - t_trace
                prof.stop()
                win.trace = Trace.from_profiler(prof)
                prof = None
                win.traced_steps = episode_steps
                after = _stats(driver.stats)
                win.traced_stats = {x: after[x] - base[x] for x in after}
            win.failed += _failed_steps(profiles)
            profiles = []
            k = 0
            ep += 1
        if (now - t_start >= seconds and len(win.snaps) == len(snap_at)
                and (not trace or ep >= 3)):
            break
    win.seconds = t_prev - t_start
    win.last = keep(driver.state)
    win.failed += _failed_steps(profiles)
    win.counts = {n: torch.stack(v).cpu() for n, v in counted.items() if v}
    return win


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof
