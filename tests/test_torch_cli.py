"""The port's CLI (``python -m consul_tpu_torch.cli``; reference
``consul_tpu/cli.py:709-1654``), on the CPU (``--device cpu --kernel
torch``):

- the port's parser takes every flag the reference's ``run``, ``trace``,
  ``chaos``, ``gameday``, ``serve-bench`` and ``prewarm`` parsers define;
- ``run`` at n = 256 prints the counters of ``run_resilient`` driven
  directly, and its report carries the keys of the reference CLI's (one
  in-process run of it at n = 64);
- ``chaos --sweep`` prints the Pareto table of ``sim.sweep`` driven
  directly; ``gameday`` at ``tests/test_torch_gameday.py``'s ``_tiny``
  shape prints ``run_gameday``'s verdict;
- a SIGTERM drill in a subprocess: ``run --ckpt-dir`` killed after its
  first checkpoint exits 75, the rerun resumes and ends in the
  uninterrupted run's state (``--state-digest``);
- ``run --budget``, ``run`` / ``chaos`` / ``prewarm --layout auto`` plan
  their run and print the plan, and ``run --n 4096 --budget 4MB`` streams
  its cohorts (``streamed: true``); a sweep over a (dc, nodes) mesh the
  CPU cannot host exits 2 with ``elastic_mesh``'s "no usable mesh",
  ``--kernel cuda`` without a card exits 2;
- ``run --elastic`` and ``chaos --elastic`` run and print ``reshards``
  (on the CPU over the one device).
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from consul_tpu_torch import cli
from consul_tpu_torch.chaos import sweep as sweep_mod
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import cluster
from consul_tpu_torch.runtime import run_resilient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--kernel", "torch"]
VERBS = ("run", "trace", "chaos", "gameday", "serve-bench", "prewarm")


def _options(parser, verb):
    sub = next(a for a in parser._actions
               if isinstance(a, __import__("argparse")._SubParsersAction))
    return {s for a in sub.choices[verb]._actions for s in a.option_strings}


def _main(capsys, *args):
    rc = cli.main([str(a) for a in args])
    out = capsys.readouterr()
    line = out.out.strip().splitlines()[-1] if out.out.strip() else None
    return rc, (json.loads(line) if line else None), out.err


@pytest.mark.parametrize("verb", VERBS)
def test_parser_takes_every_reference_flag(verb):
    from consul_tpu import cli as jcli

    missing = _options(jcli.build_parser(), verb) - _options(
        cli.build_parser(), verb)
    assert not missing, missing


def test_run_prints_run_resilient_counters(capsys):
    rc, out, _ = _main(capsys, "run", "--n", 256, "--ticks", 48, "--chunk",
                       16, "--seed", 3, *CPU)
    assert rc == 0
    sim = cluster.Simulation(SimConfig(n=256, view_degree=16), seed=3,
                             device="cpu", kernel="torch")
    report = run_resilient(sim, 48, chunk=16)
    assert out["ticks"] == 48 and out["counters"] == report.counters
    assert out["counters"]["probes_sent"] > 0


def test_run_report_has_the_reference_keys(capsys):
    from consul_tpu import cli as jcli

    assert jcli.main(["run", "--n", "64", "--view-degree", "8", "--ticks",
                      "8", "--chunk", "8", "--devices", "1"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc, out, _ = _main(capsys, "run", "--n", 64, "--view-degree", 8,
                       "--ticks", 8, "--chunk", 8, *CPU)
    assert rc == 0
    assert set(ref) <= set(out)
    assert set(ref["counters"]) <= set(out["counters"])


def test_chaos_sweep_equals_sim_sweep(capsys):
    rc, out, _ = _main(capsys, "chaos", "--n", 256, "--sweep", 3,
                       "--settle", 16, "--form-ticks", 16, "--chunk", 16,
                       "--seed", 1, *CPU)
    assert rc == 0
    sim = cluster.Simulation(SimConfig(n=256, view_degree=16), seed=1,
                             device="cpu", kernel="torch")
    sim.run(16, chunk=16, with_metrics=False)
    scens = sweep_mod.scenario_grid(256, 3)
    rows = sim.sweep(scens, chunk=16, settle=16)
    table = sweep_mod.pareto_table({"circulant": sweep_mod.family_sweep(
        sim, scens, chunk=16, settle=16)})
    assert out["families"] == ["circulant"]
    assert out["pareto"] == json.loads(json.dumps(table))
    assert [{k: v for k, v in r.items() if k != "bytes_per_tick_node"}
            for r in out["pareto"][0]["scenarios"]] == [r["slo"] for r in rows]


def test_gameday_prints_run_gamedays_verdict(capsys):
    from consul_tpu_torch.gameday import GamedayConfig, run_gameday

    shape = dict(n=128, view_degree=8, watchers=32, watch_queue=8,
                 read_batch=64, warmup_ticks=32, ticks_per_round=16,
                 steady_rounds=1, fault_rounds=2, heal_rounds=1,
                 drain_rounds=2, dcn_islands=0)
    rc, out, _ = _main(capsys, "gameday", *[
        x for k, v in shape.items()
        for x in ("--" + k.replace("_", "-"), v)], *CPU)
    verdict = run_gameday(GamedayConfig(**shape, device="cpu",
                                        kernel="torch"))
    assert rc == (0 if verdict["pass"] else 1)
    for f in ("pass", "lost_writes", "max_time_to_heal_ticks", "ledger",
              "chaos", "drained", "phases", "watchers",
              "watch_delivery_lag"):
        assert out[f] == json.loads(json.dumps(verdict[f])), f


# A child CLI process runs with one intra-op thread, as the test process
# does (torch_parity.py): PyTorch's default of one thread per core, in each
# of the drill's three children beside the other test workers, took many
# times the CPU of the work at n = 256.
CHILD_ENV = dict(os.environ, OMP_NUM_THREADS="1")
# How long the drill waits for a child to reach a checkpoint, or to end:
# a bound for a stuck child on a loaded host, not a measure of progress.
STUCK_S = 900


def _cli(args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "consul_tpu_torch.cli"] + [str(a) for a in args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=CHILD_ENV, **kw)


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def test_sigterm_drill_exits_75_and_resumes_bit_equal(tmp_path):
    base = ["run", "--n", 256, "--ticks", 768, "--chunk", 16,
            "--state-digest", *CPU]
    args = base + ["--ckpt-dir", tmp_path, "--ckpt-every-ticks", 64,
                   "--ckpt-interval-s", 0]
    whole = _cli(base)
    proc = _cli(args)
    # SIGTERM goes out as soon as the first checkpoint (tick 64) is on
    # disk: the 704 ticks still to run are what keep the run from ending
    # first, whatever the load. A run that ends, or makes no checkpoint,
    # before then fails here with its own output.
    t0 = time.monotonic()
    while not glob.glob(str(tmp_path / "*.ckpt")):
        if proc.poll() is not None or time.monotonic() - t0 > STUCK_S:
            whole.kill()
            proc.kill()
            out, err = proc.communicate()
            pytest.fail(f"no checkpoint before the run ended (rc "
                        f"{proc.returncode}, {time.monotonic() - t0:.0f} s): "
                        f"{out[-500:]} {err[-2000:]}")
        time.sleep(0.02)
    proc.send_signal(signal.SIGTERM)
    stdout, stderr = proc.communicate(timeout=STUCK_S)
    assert proc.returncode == 75, stderr[-2000:]
    stopped = _last_json(stdout)
    assert stopped["preempted"] and 0 < stopped["ticks_done"] < 768
    again = _cli(args)
    out, err = again.communicate(timeout=STUCK_S)
    assert again.returncode == 0, err[-2000:]
    resumed = _last_json(out)
    assert resumed["resumed_from_tick"] > 0
    wout, werr = whole.communicate(timeout=STUCK_S)
    assert whole.returncode == 0, werr[-2000:]
    assert resumed["state_digest"] == _last_json(wout)["state_digest"]


@pytest.mark.parametrize("args, item", [
    (["chaos", "--sweep", "2", "--n-dc", "2"], "no usable mesh"),
], ids=["sweep-mesh"])
def test_unported_flags_exit_2_naming_their_item(capsys, args, item):
    rc, out, err = _main(capsys, *args, "--n", 64, *CPU)
    assert rc == 2 and out is None
    assert item in err


@pytest.mark.parametrize("args, layout, streamed", [
    (["run", "--n", 64, "--budget", "2GB", "--ticks", 16], "packed", False),
    (["run", "--n", 64, "--layout", "auto", "--ticks", 16], "dense", False),
    (["chaos", "--n", 64, "--layout", "auto", "--form-ticks", 8,
      "--settle", 4], "dense", False),
    (["prewarm", "--n", 64, "--layout", "auto", "--chunks", 8], "dense", False),
    (["run", "--n", 4096, "--view-degree", 8, "--budget", "4MB",
      "--ticks", 8], "packed", True),
], ids=["run-budget", "run-auto", "chaos-auto", "prewarm-auto",
        "run-streamed"])
def test_memory_planner_flags(capsys, args, layout, streamed):
    """``--budget`` and ``--layout auto`` plan the run (the CPU's budget is
    host RAM, so ``auto`` keeps a small population dense); a population
    beyond its budget runs cohort-streamed."""
    rc, out, err = _main(capsys, *args, *CPU)
    assert rc == 0, err[-2000:]
    plans = out["memory_plans"] if args[0] == "prewarm" else [out["memory_plan"]]
    assert [p["layout"] for p in plans] == [layout]
    assert plans[0]["streamed"] is streamed
    if args[0] == "prewarm":
        assert out["compiled"] > 0 and all(
            s["layout"] == layout for s in out["signatures"])
    elif streamed:
        assert out["streamed"] is True and out["cohorts"] == 4
        assert out["counters"]["probes_sent"] > 0
    else:
        assert out["ticks"] > 0 and "streamed" not in out


@pytest.mark.parametrize("args", [
    ["run", "--ticks", 16, "--chunk", 8],
    ["chaos", "--form-ticks", 8, "--settle", 4, "--chunk", 8],
], ids=["run-elastic", "chaos-elastic"])
def test_elastic_runs_print_reshards(capsys, args):
    rc, out, _ = _main(capsys, *args, "--elastic", "--n", 64, *CPU)
    assert rc == 0 and out["reshards"] == 0
    assert out["ticks"] > 0


def test_cuda_kernel_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    for verb in ("run", "trace", "serve-bench", "gameday", "prewarm"):
        rc, out, err = _main(capsys, verb, "--n", 64)
        assert rc == 2 and out is None
        assert "needs a CUDA device" in err, verb
    rc, _, err = _main(capsys, "run", "--n", 64, "--device", "cpu",
                       "--kernel", "pallas")
    assert rc == 2 and "needs a CUDA device" in err
