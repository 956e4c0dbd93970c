#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the port and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run makes the cell's input from ``--seed`` (its configuration's data
maker), then drives ``csa_tpu_torch`` through its CLI on its default
route, one job after another (a closed loop of one client):

* ``warm``: ``cli.main([<mode>, <path>])`` in this process, the
  console output in a log file;
* ``cli``: a fresh ``python -m csa_tpu_torch.cli <mode> <path>`` child a
  job, as a shell user or the web frontend runs it.

Each job runs on a fresh copy of the input in a directory of its own
under ``TMPDIR``.  Set-up (imports, data, one warm-up job of the same
input, which builds the kernels on a checkout's first run) ends where
the window starts; the job still running when ``--seconds`` end is
finished and counted.  The directories of a sample of the jobs, drawn
from the seed (every ``check_every``-th job of the traffic file from a
seeded offset, and the window's last job), are kept; the others are
deleted as they finish.  Once the window has closed, the plain reference
(``perfbench/reference``) works every output out again from the input,
and each kept job's files are compared with its by digest.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs
the jobs with ``--profile`` under ``torch.profiler`` and prints the
per-layer metrics (``perfbench/metrics/<name>.py``), the device's busy
and window seconds and a breakdown.  The numbers compared end standard
error and the result line, each beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import re  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import manifest, outputs, tracing  # noqa: E402

# top-level module names that may not be loaded in the process that
# prints the result (the JAX package's name is a prefix of the port's,
# so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "csa_tpu")
INPUT_NAME = "set.txt"
GIB = float(1 << 30)
# phases of a CLI job that start at its top level (cli.py::_run)
TOP_PHASES = ("io.load_fasta", "rot.block_stage[", "rot.chains",
              "rot.artifacts", "rot.device_verify", "align.total",
              "report.circular_plot")
PROFILE_LINE = re.compile(r"^>\s{3}(\S+)\s+([0-9.]+)s")


def phase_sum(phases, names):
    """Seconds of the phases ``names`` (a name ending in ``[`` takes
    every route) in a job's ``{phase: seconds}``; None if none ran."""
    hit = [v for k, v in phases.items()
           if any(k == n or (n.endswith("[") and k.startswith(n))
                  for n in names)]
    return sum(hit) if hit else None


def _flags(traffic, device, trace):
    """The CLI flags of a job: the mix's, then the device when it is
    not the default, then ``--profile`` when traced."""
    flags = list(traffic.get("flags", []))
    if device != "cuda":
        flags += ["--device", device]
    return flags + (["--profile"] if trace else [])


class BenchError(RuntimeError):
    """A run that cannot give a result."""


class Run:
    """What one run measured; the per-layer readers take it."""

    def __init__(self, cell):
        self.cell = cell
        self.jobs = []  # dicts: wall_s, ok, digests, phases, counters
        self.kernel_calls = {"profile_dp": []}
        self.device_events = []
        self.host_spans = []
        self.window_span = (0.0, 0.0)
        self.busy_s = None
        self.window_s = None

    def phase_median_ms(self, *names):
        """Median over the jobs of the summed phases ``names`` (a name
        ending in ``[`` takes every route), in ms; None where no job
        ran any of them."""
        per_job = [phase_sum(job.get("phases", {}), names)
                   for job in self.jobs]
        per_job = [v for v in per_job if v is not None]
        return statistics.median(per_job) * 1e3 if per_job else None

    def device_s(self, match):
        """Seconds of device events whose name satisfies ``match``."""
        return sum(e - s for name, s, e in self.device_events
                   if match(name)) / 1e6


def _check_modules(err):
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=err)
        raise SystemExit(3)


def _mode_argv(mode, path):
    return [path] if mode == "N" else [mode, path]


def _job_dir(work, i, inp):
    d = os.path.join(work, f"job{i}")
    os.mkdir(d)
    path = os.path.join(d, INPUT_NAME)
    shutil.copyfile(inp, path)
    return d, path


def sample_of(seed, every):
    """Whether job ``i`` of the window is in the seed's sample: every
    ``every``-th job from an offset drawn from the seed."""
    offset = random.Random(seed).randrange(every)
    return lambda i: i % every == offset


class WarmRunner:
    """Jobs through ``cli.main`` in this process."""

    def __init__(self, run, inp, work, device, trace):
        from csa_tpu_torch import cli
        from csa_tpu_torch.utils import PROFILER

        self.run, self.inp, self.work = run, inp, work
        self.cli, self.profiler = cli, PROFILER
        self.flags = _flags(run.cell.traffic, device, trace)
        self.trace = trace
        self.calls = None

    def _span(self):
        if not self.trace:
            return contextlib.nullcontext()
        from torch.autograd.profiler import record_function

        return record_function("job")

    def job(self, i):
        d, path = _job_dir(self.work, i, self.inp)
        argv = _mode_argv(self.run.cell.traffic["mode"], path) + self.flags
        self.profiler.reset()
        calls = self.calls = {"profile_dp": []}
        ok = False
        t = time.perf_counter()
        try:
            with self._span():
                ok = self.cli.main(argv) == 0
        except SystemExit as e:
            ok = not e.code
        except Exception:  # a failed job is counted, and the run goes on
            traceback.print_exc()
        rec = {"wall_s": time.perf_counter() - t, "ok": ok}
        if self.trace:
            rec["phases"] = dict(self.profiler.phases)
            rec["counters"] = dict(self.profiler.counters)
            for k, v in calls.items():
                self.run.kernel_calls[k].extend(v)
        return rec, d

    @contextlib.contextmanager
    def traced_window(self):
        """The window under ``torch.profiler``, each phase and job a
        host span, the profile DP's launch shapes recorded."""
        import torch
        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        from csa_tpu_torch.dp import profile as dp_profile
        from csa_tpu_torch.utils import PhaseTimer

        phase, upload = PhaseTimer.phase, dp_profile._upload

        @contextlib.contextmanager
        def spanned(timer, name):
            with record_function(name), phase(timer, name):
                yield

        def profile_upload(items, device, **kw):
            self.calls["profile_dp"].append(
                [(len(it[0]), len(it[1])) for it in items])
            return upload(items, device, **kw)

        PhaseTimer.phase = spanned
        dp_profile._upload = profile_upload
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            with profile(activities=acts) as prof:
                with record_function("perfbench.window"):
                    yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            PhaseTimer.phase = phase
            dp_profile._upload = upload
        device, host = tracing.from_profiler(prof)
        window = [s for s in host if s[0] == "perfbench.window"][0]
        self.run.device_events = device
        self.run.host_spans = [s for s in host if s is not window]
        self.run.window_span = window[1:]
        self.run.busy_s = tracing.busy_us(device, *window[1:]) / 1e6
        self.run.window_s = (window[2] - window[1]) / 1e6

    def breakdown(self):
        t0, t1 = self.run.window_span
        return {"device_ops": tracing.top_ops(self.run.device_events),
                "idle_gaps": tracing.idle_by_host(
                    self.run.device_events, self.run.host_spans, t0, t1,
                    "harness, between jobs")}

    def peak_rss_bytes(self):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class CliRunner:
    """Each job a fresh ``python -m csa_tpu_torch.cli`` child.  Traced,
    every child runs with ``--profile`` and the window's first child
    also under ``torch.profiler`` (``CSA_TPU_TORCH_TRACE``), whose
    start-up the others do not pay: that child is the traced window."""

    def __init__(self, run, inp, work, device, trace):
        import csa_tpu_torch

        self.run, self.inp, self.work = run, inp, work
        prog_root = os.path.dirname(os.path.dirname(
            os.path.abspath(csa_tpu_torch.__file__)))
        self.flags = _flags(run.cell.traffic, device, trace)
        self.trace = trace
        path = os.environ.get("PYTHONPATH")
        self.env = dict(os.environ, PYTHONPATH=prog_root + (
            os.pathsep + path if path else ""))
        self.traced = None  # (device events, busy us, span us, wall s)

    def job(self, i):
        d, path = _job_dir(self.work, i, self.inp)
        cmd = [sys.executable, "-m", "csa_tpu_torch.cli",
               *_mode_argv(self.run.cell.traffic["mode"], path), *self.flags]
        env = self.env
        trace_dir = os.path.join(self.work, "trace")
        traced = self.trace and i == 0
        if traced:
            env = dict(env, CSA_TPU_TORCH_TRACE=trace_dir)
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=d, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        rec = {"wall_s": time.perf_counter() - t, "ok": proc.returncode == 0}
        if not rec["ok"]:
            print(proc.stdout[-4000:], file=sys.stderr)
        if self.trace:
            rec["phases"] = {m.group(1): float(m.group(2))
                             for m in map(PROFILE_LINE.match,
                                          proc.stdout.splitlines()) if m}
            rec["outside_s"] = rec["wall_s"] - (
                phase_sum(rec["phases"], TOP_PHASES) or 0.0)
            rec["traced"] = traced
        if traced:
            device, (t0, t1) = tracing.from_chrome(
                os.path.join(trace_dir, "trace.json"))
            self.traced = (device, tracing.busy_us(device, t0, t1),
                           t1 - t0, rec["wall_s"])
            shutil.rmtree(trace_dir, ignore_errors=True)
        return rec, d

    @contextlib.contextmanager
    def traced_window(self):
        yield
        device, busy_us, _, wall_s = self.traced
        self.run.device_events = device
        self.run.busy_s = busy_us / 1e6
        self.run.window_s = wall_s

    def breakdown(self):
        _, busy_us, span_us, wall_s = self.traced
        return {"device_ops": tracing.top_ops(self.run.device_events),
                "idle_gaps": [
                    ["outside the traced job: start-up, exit",
                     wall_s - span_us / 1e6],
                    ["inside the traced job", (span_us - busy_us) / 1e6]]}

    def peak_rss_bytes(self):
        return resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024


RUNNERS = {"warm": WarmRunner, "cli": CliRunner}


class CardMemory:
    """The card's peak memory in use, sampled by ``nvidia-smi`` while
    the jobs of fresh children run (this process holds no context)."""

    def __init__(self):
        self.peak = 0
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits", "-lms", "1000"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            vals = [int(v) for v in line.split(",") if v.strip().isdigit()]
            if vals:
                self.peak = max(self.peak, max(vals) << 20)

    def stop(self):
        self.proc.terminate()
        self.proc.wait()
        self.reader.join(timeout=10)
        return self.peak


def _pool_map(pool):
    """``map`` over a process pool, the largest items first."""
    def run(fn, items):
        items = list(items)
        order = sorted(range(len(items)),
                       key=lambda i: -sum(len(x) for x in items[i]))
        done = pool.map(fn, [items[i] for i in order], chunksize=1)
        out = [None] * len(items)
        for i, res in zip(order, done):
            out[i] = res
        return out
    return run


def reference_digests(mode, inp, work, control=None):
    """Digests of the plain reference's outputs for the input file."""
    import multiprocessing

    from perfbench.reference import pipeline

    d = os.path.join(work, "reference")
    os.mkdir(d)
    path = os.path.join(d, INPUT_NAME)
    shutil.copyfile(inp, path)
    if mode == "N":
        workers = max(1, min(6, (os.cpu_count() or 2) - 1))
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            pipeline.run(mode, path, control=control, map_fn=_pool_map(pool))
            pool.close()
            pool.join()
    else:
        pipeline.run(mode, path, control=control)
    want = outputs.digests(d, INPUT_NAME)
    shutil.rmtree(d)
    return want


def checks_of(run, want):
    """{name: (value, limit)} of the numbers that decide ``correct``:
    every job's exit, and the outputs of the sampled jobs."""
    failed = sum(not j["ok"] for j in run.jobs)
    checks = {"jobs_failed": (failed, 0)}
    wrong = outputs.wrong_jobs([j["digests"] for j in run.jobs
                                if j["ok"] and "digests" in j],
                               want, run.cell.traffic["mode"])
    for kind, n in wrong.items():
        checks[f"{kind}_wrong_jobs"] = (n, 0)
    return checks


def end_to_end(run, runner, setup_s, window_s, peak_rss):
    walls = [j["wall_s"] for j in run.jobs]
    values = {"setup_s": setup_s, "peak_host_gib": peak_rss / GIB}
    per_job = window_s / len(walls)
    if isinstance(runner, CliRunner):
        values["cli_job_s"] = per_job
    else:
        values["job_s"] = per_job
        if len(walls) >= 2:
            values["job_p95_s"] = statistics.quantiles(walls, n=20)[18]
    return values


def run_cell(name, seed, seconds, trace, *, device="cuda",
             root=manifest.ROOT):
    """One run of cell ``name``; returns the result line's object."""
    cell = manifest.cell(name, root)
    run = Run(cell)
    work = tempfile.mkdtemp(prefix="perfbench-")
    try:
        inp = os.path.join(work, INPUT_NAME)
        manifest.maker(cell.config, root).make(cell.config["params"], seed,
                                               inp)
        runner = RUNNERS[cell.traffic["runner"]](run, inp, work, device,
                                                 trace)
        warm, d = runner.job("warmup")
        shutil.rmtree(d)
        if not warm["ok"]:
            raise BenchError("the warm-up job failed")
        if trace:
            run.kernel_calls = {"profile_dp": []}
        sampled = sample_of(seed, int(cell.traffic["check_every"]))
        kept = []
        memory = (CardMemory() if device == "cuda"
                  and isinstance(runner, CliRunner) else None)
        setup_s = time.perf_counter() - T_START
        window = runner.traced_window() if trace else contextlib.nullcontext()
        try:
            with window:
                t0 = time.perf_counter()
                while True:
                    i = len(run.jobs)
                    rec, d = runner.job(i)
                    run.jobs.append(rec)
                    last = time.perf_counter() - t0 >= seconds
                    if last or sampled(i):
                        kept.append((rec, d))
                    else:
                        shutil.rmtree(d)
                    if last:
                        break
                window_s = time.perf_counter() - t0
            peak_rss = runner.peak_rss_bytes()
        finally:
            card_peak = memory.stop() if memory else None
        dev = _device(device, run.cell.chips, card_peak)
        for rec, d in kept:
            rec["digests"] = outputs.digests(d, INPUT_NAME)
            shutil.rmtree(d)
        want = reference_digests(cell.traffic["mode"], inp, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    checks = checks_of(run, want)
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": len(run.jobs),
        "failed": checks["jobs_failed"][0],
    }
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"], root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=run.busy_s, window_s=run.window_s)
        result.update(metrics=metrics, device=dev,
                      breakdown=runner.breakdown())
    else:
        values = end_to_end(run, runner, setup_s, window_s, peak_rss)
        result.update(metrics={m["name"]: {"value": values[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end}, device=dev)
    result["job_walls"] = [j["wall_s"] for j in run.jobs]
    result["compared"] = sum("digests" in j for j in run.jobs)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def _device(device, chips, card_peak):
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if card_peak is None:
        card_peak = torch.cuda.max_memory_reserved()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": card_peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(ROOT, "perfbench", "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    err = os.fdopen(os.dup(2), "w")
    out = os.fdopen(os.dup(1), "w")
    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {torch.cuda.device_count()}", file=err)
        return 2
    try:
        import csa_tpu_torch
    except ImportError as e:
        print(f"perfbench: the program is missing: {e}", file=err)
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(
            csa_tpu_torch.__file__))) != ROOT:
        print("perfbench: csa_tpu_torch is not this checkout's", file=err)
        return 2

    # the program's console output, and anything native code writes to
    # the two streams, goes to a log; the result line and the checks to
    # the original streams
    log_path = os.path.join(tempfile.gettempdir(),
                            f"perfbench-{os.getpid()}.log")
    log = open(log_path, "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    failure = None
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except BaseException:  # reported below, on the original stream
        failure = traceback.format_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(out.fileno(), 1)
        os.dup2(err.fileno(), 2)
        log.close()
        with open(log_path, errors="replace") as f:
            tail = f.read()[-6000:]
        os.unlink(log_path)
    if failure is not None:
        print(tail, file=err)
        print(failure, file=err)
        return 1
    _check_modules(err)
    walls = result.pop("job_walls")
    compared = result.pop("compared")
    q = (statistics.quantiles(walls, n=4) if len(walls) > 1
         else walls * 3)
    print(f"perfbench: {len(walls)} jobs ({compared} compared), wall min "
          f"{min(walls):.4f} quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f} "
          f"max {max(walls):.4f} s", file=err)
    print("perfbench: job walls in order " +
          " ".join(f"{w:.4f}" for w in walls), file=err)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
