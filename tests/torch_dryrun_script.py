"""Subprocess helper of ``tests/test_torch_lm_sharding.py``: runs the
port's dry run on a ``fake`` process group (which must not outlive the
check in a test process) and prints its figures as JSON.

    python tests/torch_dryrun_script.py run D M ARCH:SEQ:BATCH:KIND ...
        ``run_one`` of the reduced config of each ARCH (f32) at the shape
        (SEQ, BATCH, KIND) on a D x M ("data", "model") fake mesh; one
        JSON object ``{case: result}``
    python tests/torch_dryrun_script.py collective
        ``analyse_ops`` of an all-gather over a fake group of 4
"""
import dataclasses
import json
import logging
import sys

import torch


def main():
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from repro_torch.launch.dryrun import fake_group, run_one
    from repro_torch.launch.hlo_cost import analyse_ops
    from repro_torch.launch.mesh import make_device_mesh
    if sys.argv[1] == "collective":
        import torch.distributed._functional_collectives as funcol
        fake_group(4)
        mesh = make_device_mesh((2, 2), ("data", "model"), "cpu")
        x = torch.ones(3, 5)
        gather = getattr(funcol, "all_gather_single",
                         None) or funcol.all_gather_tensor
        _, cost = analyse_ops(lambda: funcol.wait_tensor(
            gather(x, 0, mesh.get_group("model"))))
        print(json.dumps({"bytes": cost.collective_bytes,
                          "counts": cost.collective_counts}))
        return
    from repro_torch.configs import get_reduced
    d, m = int(sys.argv[2]), int(sys.argv[3])
    fake_group(d * m)
    mesh = make_device_mesh((d, m), ("data", "model"), "cpu")
    out = {}
    for case in sys.argv[4:]:
        arch, seq, batch, kind = case.split(":")
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        out[case] = run_one(arch, (int(seq), int(batch), kind),
                            cfg_override=cfg, device="cpu", mesh=mesh)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
