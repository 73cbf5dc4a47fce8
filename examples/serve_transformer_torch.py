"""Serve demo of the PyTorch port: batched greedy decode for any of the 10
assigned architectures, through ``repro_torch`` only.

Runs the reduced config of each requested architecture through the serve
path (one-token steps against a KV/SSM cache) and prints throughput — a
thin wrapper over ``repro_torch.launch.serve lm``, the twin of
``examples/serve_transformer.py``.

    PYTHONPATH=src python examples/serve_transformer_torch.py --arch hymba-1.5b
    PYTHONPATH=src python examples/serve_transformer_torch.py --all --device cpu

It runs on the card unless given ``--device cpu``.
"""
import argparse

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import serve


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--all", action="store_true",
                    help="serve every assigned architecture (reduced)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.all else [args.arch]
    return [serve.main(["lm", "--arch", arch, "--steps", str(args.steps),
                        "--device", args.device]) for arch in archs]


if __name__ == "__main__":
    main()
