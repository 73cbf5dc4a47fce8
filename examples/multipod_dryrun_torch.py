"""Multi-pod dry run of the port: one step of one (arch x shape) pair on
the production meshes with no real devices (a ``fake`` process group and
fake tensors), and its roofline terms over one H100's constants — the
smallest end-to-end path through the port's mesh.py / sharding.py /
dryrun.py / hlo_cost.py, the twin of ``examples/multipod_dryrun.py``.

    PYTHONPATH=src python examples/multipod_dryrun_torch.py \\
        --arch hymba-1.5b --shape train_4k [--multi-pod] [--device cpu]

The terms are counts over the card's published peaks
(``repro_torch.launch.mesh.HW``), not timings.
"""
import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (no memory is touched)")
    args = ap.parse_args()

    from repro_torch.launch.dryrun import run_one
    from repro_torch.launch.mesh import HW
    res = run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                  device=args.device)
    print(json.dumps(res, indent=1))

    t_c = res["hlo_flops_per_device"] / HW.PEAK_BF16_FLOPS
    t_m = res["hlo_bytes_per_device"] / HW.HBM_BW
    t_x = res["collective_bytes_per_device"] / HW.LINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])
    print(f"\nroofline terms: compute {t_c:.3e}s  memory {t_m:.3e}s  "
          f"collective {t_x:.3e}s  -> {dom[0]}-bound")


if __name__ == "__main__":
    main()
