"""Walls of the port's CLI as 2 processes of one world sharing card 0
over gloo, one world after another: ``chip_smoke.run_cli_processes``
(mode N at ``--backend sharded --mesh 8x1``, every process's output
held to the fixtures), once the native host library and the kernels are
built.  Run from the root of a checkout, on a machine with a card::

    python tests/torch_cli_world_walls.py Primates --worlds 4

One line a world: ``cli_world <set> group_s=<s> cli_s=<p0>/<p1>``, the
group's wall with the interpreters' start, and each process's
``cli.main`` wall."""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from csa_tpu_torch import kernels, native  # noqa: E402
from csa_tpu_torch.parallel import distributed  # noqa: E402
from csa_tpu_torch.tools import files  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("name", choices=("Primates", "Set3"))
    parser.add_argument("--worlds", type=int, default=4)
    a = parser.parse_args()
    if not native.available():
        raise RuntimeError("the port's native host library did not build")
    kernels.build()
    kernels.load()
    for _ in range(a.worlds):
        procs, wall = chip_smoke.run_cli_processes(
            distributed, files, a.name, 2, "gloo", ["0", "0"])
        print(f"cli_world {a.name} group_s={wall:.3f} cli_s="
              + "/".join(f"{p['wall_s']:.3f}" for p in procs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
