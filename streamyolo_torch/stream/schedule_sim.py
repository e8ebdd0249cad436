"""Exact-arithmetic scheduling simulator: the port's own copy of
``streamyolo_tpu/stream/schedule_sim.py``.

The cumulative temporal mismatch of the streaming scheduling policies
(idle-free, idle-next, shrinking-tail, half-tail, half-next-tail), in
``fractions.Fraction`` so that the comparison is exact. The analytical
companion of the online loop's ``dynamic_schedule``.

    python -m streamyolo_torch.stream.schedule_sim

prints the policy table for r = 1.5 frame periods, T = 13, eta = 0.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Callable, Dict, Union

Number = Union[int, float, Fraction]


def sim(policy: Callable[[Number, Number], bool], r: Number, T: int, eta: int = 0) -> Number:
    """Cumulative temporal mismatch of ``policy`` for runtime ``r`` (in frame
    periods) over ``T`` frames. ``policy(done_at, r) -> wait?`` decides
    whether to idle until the next frame boundary before starting work.

    A one-server queue ticked at frame boundaries: one job is always in
    flight, ``(done_at, src)``, when it finishes and its input frame. The
    query at ``now + eta`` is answered by the freshest finished job and pays
    the age of that job's input frame."""
    if eta < -1:
        raise NotImplementedError("queries more than one frame ahead of observations")
    total_age: Number = 0
    freshest = None  # input frame of the newest finished job
    job = (r, 0)  # the first job takes frame 0 the instant it appears
    for now in range(T - eta):
        done_at, src = job
        if done_at < now:  # the job in flight finished before this tick
            freshest = src
            if policy(done_at, r):
                # idle to the boundary and take the brand-new frame
                job = (now + r, now)
            else:
                # start at once on the newest captured frame: now - 1 (a
                # start mid-period), or now when the job ended exactly on
                # the boundary or the pipeline is frame-synchronous
                synchronous = done_at == now or freshest == now - 1
                job = (done_at + r, now if synchronous else now - 1)
        if now + eta >= 0 and freshest is not None:
            total_age += now + eta - freshest
    return total_age


def tail(x: Number) -> Number:
    return x - math.floor(x)


def p_idle_free(t_finish, r) -> bool:
    return False


def p_idle_next(t_finish, r) -> bool:
    return True


def p_shrinking_tail(t_finish, r) -> bool:
    return tail(t_finish) > tail(t_finish + r)


def p_half_tail(t_finish, r) -> bool:
    return tail(t_finish) >= Fraction(1, 2)


def p_half_next_tail(t_finish, r) -> bool:
    return tail(t_finish + r) < Fraction(1, 2)


POLICIES: Dict[str, Callable] = {
    "idle_free": p_idle_free,
    "idle_next": p_idle_next,
    "shrinking_tail": p_shrinking_tail,
    "half_tail": p_half_tail,
    "half_next_tail": p_half_next_tail,
}


def main(r: Number = 1 + Fraction(1, 2), T: int = 13, eta: int = 0):
    for name, policy in POLICIES.items():
        cmismatch = sim(policy, r, T, eta)
        print(f"{name}: {cmismatch}, {float(cmismatch) / T:.6g}")


if __name__ == "__main__":
    main()
