"""Two-process worlds on the CPU, one after another, beside processes that
spin on the CPU as the other workers of a loaded test run would; counts
the worlds in which a process aborted (died of a signal) or failed::

    python tests/torch_teardown_stress.py ranks --worlds 100 --busy 6
    python tests/torch_teardown_stress.py dryrun --worlds 100 --busy 6
    python tests/torch_teardown_stress.py cli --worlds 100 --busy 6

``ranks`` is the teardown loop (csa_tpu_torch.parallel.teardown), one
world a pair of processes; ``dryrun`` is ``run_multiprocess_dryrun(2,
2, "cpu")``; ``cli`` is the CLI in mode N as 2 processes at ``--backend
sharded --mesh 4x1`` on a seeded set, each in a directory of its own,
both writing the same output.  The last line is ``stress <kind>
worlds=<n> aborts=<m> failed=<k> wall_s=<s>``."""

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from csa_tpu_torch.parallel import distributed, teardown  # noqa: E402

TIMEOUT = 300


def family_fasta(seed=1, k=6, n=360) -> str:
    """k rotated, mutated copies of one random sequence, as FASTA."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    rows = []
    for i in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idx = rng.integers(0, n, size=n // 40)
        row[idx] = rng.integers(0, 4, size=len(idx))
        rows.append(f">s{i}\n{letters[row].tobytes().decode()}\n")
    return "".join(rows)


def dryrun_world():
    """(exit codes, ok) of one run_multiprocess_dryrun(2, 2, "cpu")."""
    res = distributed.run_multiprocess_dryrun(2, 2, "cpu", timeout=TIMEOUT)
    return res.get("exit_codes"), bool(res.get("ok"))


def cli_world():
    """(exit codes, ok) of the CLI as 2 processes; ok when both exit 0
    and write the same files."""
    port = distributed.free_port()
    env = teardown._env(ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        argvs, cwds = [], []
        for pid in range(2):
            d = os.path.join(tmp, f"p{pid}")
            os.mkdir(d)
            with open(os.path.join(d, "family.txt"), "w") as f:
                f.write(family_fasta())
            argvs.append([sys.executable, "-m", "csa_tpu_torch.cli",
                          "family.txt", "--device", "cpu", "--backend",
                          "sharded", "--mesh", "4x1", "--coordinator",
                          f"127.0.0.1:{port}", "--num-processes", "2",
                          "--process-id", str(pid)])
            cwds.append(d)
        try:
            outs = distributed.run_processes(argvs, timeout=TIMEOUT,
                                             cwds=cwds, envs=[env] * 2)
        except TimeoutError:
            return None, False
        files = []
        for d in cwds:
            try:
                files.append([open(os.path.join(d, f"family-{s}.fasta"),
                                   "rb").read()
                              for s in ("Rotated", "Aligned")])
            except OSError:
                files.append(None)
    rcs = [rc for rc, _, _ in outs]
    return rcs, not any(rcs) and files[0] is not None and files[0] == files[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("kind", choices=("ranks", "dryrun", "cli"))
    parser.add_argument("--worlds", type=int, default=100)
    parser.add_argument("--busy", type=int, default=6,
                        help="processes spinning on the CPU meanwhile")
    a = parser.parse_args()
    hogs = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(a.busy)]
    t0 = time.perf_counter()
    try:
        if a.kind == "ranks":
            res = teardown.run_teardown_loop(a.worlds, device="cpu",
                                             timeout=TIMEOUT)
            aborts, failed = res["aborts"], res["failed"]
        else:
            world = dryrun_world if a.kind == "dryrun" else cli_world
            aborts = failed = 0
            for _ in range(a.worlds):
                rcs, ok = world()
                aborts += bool(rcs and any(rc < 0 for rc in rcs))
                failed += not ok
    finally:
        for h in hogs:
            h.kill()
            h.wait()
    print(f"stress {a.kind} worlds={a.worlds} aborts={aborts} "
          f"failed={failed} wall_s={time.perf_counter() - t0:.3f}",
          flush=True)
    return 0 if aborts == failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
