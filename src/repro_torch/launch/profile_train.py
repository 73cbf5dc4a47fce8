"""Where the training slice's time goes on the card.

``python -m repro_torch.launch.profile_train gnn [launch.train gnn flags]``

Runs the slice once through :func:`repro_torch.launch.train.train_gnn`
(which builds the kernels and warms every step kind up), then profiles
with ``torch.profiler`` (CPU and CUDA activity) three windows of
``STEPS`` steps each from the trained state: ``refresh``, ``cached`` and
``pipelined``.  For each it prints one JSON line in the
format of :mod:`.profile_serve`: the wall seconds of the window, the
device-busy seconds, the idle share ``1 - busy / wall`` and the
operations with the most device and host time.  The profiler's own cost
is inside the wall time, so the idle share is an upper bound for the
unprofiled run.
"""
from __future__ import annotations

import json

from .profile_serve import _profiled, _summary
from .train import build_parser, train_gnn

STEPS = 3   # steps in each profiled window


def profile_train(args) -> list[dict]:
    out_report, ctx = train_gnn(args)
    rt, params = ctx["runtime"], ctx["params"]
    opt_state = ctx["report"].final_opt_state
    out = []
    for kind in ("refresh", "cached", "pipelined"):
        step = getattr(rt, f"step_{kind}")

        def window():
            state = (params, opt_state, rt.caches0)
            for _ in range(STEPS):
                state = step(*state)[:3]
        prof, wall = _profiled(window)
        out.append({**_summary(kind, prof, wall), "steps": STEPS})
    for rec in out:
        print(json.dumps(rec), flush=True)
    return out


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    if args.device != "cuda":
        raise SystemExit("profile_train measures the card: use --device cuda")
    return profile_train(args)


if __name__ == "__main__":
    main()
