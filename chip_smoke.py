#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (`alphatriangle_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout around this file; exits
non-zero, printing no result, without either. Phases, any failure of
which exits non-zero:

1. Prints the card (`nvidia-smi` name and power limit), the torch and
   CUDA versions, and builds every kernel from `alphatriangle_tpu_torch/
   csrc/` (one `nvcc` per source, all started together).
2. Kernels: at the flagship shapes of the serving path (B=64 slots,
   N=65 node rows, A=360, W=32, D=8) each kernel must be bit-equal
   (`torch.equal`) to its plain PyTorch version on the same card inputs,
   the backup's inputs holding duplicate edges and inactive entries.
   Times the kernel, its plain version and one library call with CUDA
   events, and computes the least time the card could take.
3. Serve: the full-width default configuration (8x15 board, 3 slots,
   bf16 net of seed 0, 64 slots x 64 simulations, W=32, depth 8) through
   `run_simulated_load` -> `PolicyService.dispatch` for a few
   dispatches. Every request must be answered with an action valid for
   its live lane, the search outputs must be finite, and the launch
   counters must show 16 `gather_rows` and 2 `backup_update` launches per
   dispatch.
4. Reference: a small search on the card must give the visit counts of
   the same search on the CPU (plain versions), under a stub net whose
   outputs are exact.

Then one JSON line of kernel figures, the card line, `kernels: ...`, and
as the last line `{"ok": true, "device": {...}}`.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SERVE_DISPATCHES = 8
TIMED_LAUNCHES = 100

# Published HBM rates (NVIDIA data sheets), bytes/s, by card name.
_HBM_RATES = (
    ("H200", 4.8e12),
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def hbm_rate(name: str) -> float:
    for key, rate in _HBM_RATES:
        if key in name:
            return rate
    fail(f"no published memory rate for card {name!r}")


def sleep_cycles_per_ms() -> float:
    """The rate of `torch.cuda._sleep`, which spins one thread for a
    number of clock cycles, timed with CUDA events."""
    import torch

    torch.cuda._sleep(1000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(fn, cycles_per_ms: float, iters: int = TIMED_LAUNCHES) -> float:
    """Median per-call device time over `iters` calls, between CUDA
    events around each call. A sleep kernel queued first keeps the card
    busy while the host enqueues the timed calls, so the events time the
    card's work rather than the host's launch rate. A call of more
    launches than the card's queue holds (the plain backup) is timed at
    the host's rate all the same."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    torch.cuda.synchronize()
    pairs = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    torch.cuda._sleep(int(cycles_per_ms * (1.5 * host_ms * iters + 1.0)))
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_phase(torch, dev, rate: float) -> dict:
    import importlib

    # The package re-exports the dispatchers under the modules' names.
    g = importlib.import_module("alphatriangle_tpu_torch.ops.gather_rows")
    mb = importlib.import_module("alphatriangle_tpu_torch.ops.mcts_backup")

    b, n, a, w, d = 64, 65, 360, 32, 8
    k = 6 * a
    gen = torch.Generator(device=dev).manual_seed(0)
    cycles = sleep_cycles_per_ms()
    report = {}

    # --- gather_rows ---
    stats = torch.rand((b, n, k), generator=gen, device=dev)
    idx = torch.randint(0, n, (b, w), generator=gen, device=dev)
    out_k = g.gather_rows_cuda(stats, idx)
    out_p = g.gather_rows_plain(stats, idx)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p):
        fail("gather_rows kernel differs from its plain version")
    rows = torch.unique(torch.arange(b, device=dev)[:, None] * n + idx).numel()
    gather_bytes = rows * k * 4 + b * w * k * 4 + b * w * 8
    lib_idx = idx[..., None].expand(b, w, k)
    report["gather_rows"] = {
        "name": "gather_rows",
        "route": "cuda",
        "source": "alphatriangle_tpu_torch/csrc/gather_rows.cu",
        "replaces": "alphatriangle_tpu/ops/gather_rows.py:49",
        "max_abs_err": float((out_k - out_p).abs().max()),
        "ms": time_ms(lambda: g.gather_rows_cuda(stats, idx), cycles),
        "plain_ms": time_ms(lambda: g.gather_rows_plain(stats, idx), cycles),
        "bound_ms": gather_bytes / rate * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: torch.gather(stats, 1, lib_idx), cycles),
        "bytes": gather_bytes,
    }

    # --- backup_update: duplicate edges and inactive entries ---
    def planes():
        g2 = torch.Generator(device=dev).manual_seed(1)
        children = torch.full((b, n, a), -1.0, device=dev)
        children[:, 0, :8] = torch.randint(1, n, (b, 8), generator=g2, device=dev).float()
        return [
            torch.randint(0, 5, (b, n, a), generator=g2, device=dev).float(),
            torch.randn((b, n, a), generator=g2, device=dev),
            children,
            torch.randn((b, n, a), generator=g2, device=dev),
        ]

    parents = torch.randint(0, 4, (b, w), generator=gen, device=dev)
    actions = torch.randint(0, 6, (b, w), generator=gen, device=dev)
    parents[:, 1::4], actions[:, 1::4] = parents[:, 0::4], actions[:, 0::4]  # forced duplicates
    new_child = torch.where(
        torch.rand((b, w), generator=gen, device=dev) < 0.5,
        torch.randint(1, n, (b, w), generator=gen, device=dev).float(),
        torch.tensor(-1.0, device=dev),
    )
    rewards = torch.randn((b, w), generator=gen, device=dev)
    rec_active = torch.rand((b, w, d), generator=gen, device=dev) < 0.7
    rec_node = torch.where(
        rec_active, torch.randint(0, 4, (b, w, d), generator=gen, device=dev), -1
    )
    rec_action = torch.where(
        rec_active, torch.randint(0, 6, (b, w, d), generator=gen, device=dev), -1
    )
    returns = torch.randn((b, w, d), generator=gen, device=dev)
    if not bool((~rec_active).any()):
        fail("backup inputs hold no inactive entry")
    rest = (parents, actions, new_child, rewards, rec_node, rec_action, rec_active, returns)
    got = mb.backup_update_cuda(*planes(), *rest)
    want = mb.backup_update_plain(*planes(), *rest)
    torch.cuda.synchronize()
    for name, x, y in zip(("e_visits", "e_value", "children", "e_reward"), got, want):
        if not torch.equal(x, y):
            fail(f"backup_update kernel differs from its plain version on {name}")
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))

    bcol = torch.arange(b, device=dev)[:, None]
    ins_flat = (bcol * n * a + parents * a + actions).reshape(-1)
    bk_flat = (bcol[..., None] * n * a + rec_node.clamp(min=0) * a + rec_action.clamp(min=0))
    bk_flat = bk_flat.reshape(-1)
    backup_bytes = (
        torch.unique(ins_flat).numel() * 12  # children read+write, reward write
        + torch.unique(bk_flat).numel() * 16  # visits and value read+write
        + b * w * (8 + 8 + 4 + 4)
        + b * w * d * (8 + 8 + 1 + 4)
    )
    cnt = rec_active.float().reshape(-1)
    val = torch.where(rec_active, returns, 0.0).reshape(-1)
    lib_planes = planes()

    def library_chain():
        ev, eq, ch, er = lib_planes
        ch.view(-1).scatter_reduce_(0, ins_flat, new_child.reshape(-1), "amax")
        er.view(-1).index_put_((ins_flat,), rewards.reshape(-1))
        ev.view(-1).index_put_((bk_flat,), cnt, accumulate=True)
        eq.view(-1).index_put_((bk_flat,), val, accumulate=True)

    kp, pp = planes(), planes()
    report["backup_update"] = {
        "name": "backup_update",
        "route": "cuda",
        "source": "alphatriangle_tpu_torch/csrc/mcts_backup.cu",
        "replaces": "alphatriangle_tpu/ops/mcts_backup.py:80",
        "max_abs_err": err,
        "ms": time_ms(lambda: mb.backup_update_cuda(*kp, *rest), cycles),
        "plain_ms": time_ms(lambda: mb.backup_update_plain(*pp, *rest), cycles, iters=20),
        "bound_ms": backup_bytes / rate * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(library_chain, cycles),
        "bytes": backup_bytes,
    }

    # torch.argmax must return the first maximum on the card, as on the
    # CPU and in jnp.argmax: the descent and the action rule rely on it.
    ties = torch.randint(0, 3, (256, 360), generator=gen, device=dev).float()
    if not torch.equal(ties.argmax(dim=-1).cpu(), ties.cpu().argmax(dim=-1)):
        fail("torch.argmax on the card does not return the first maximum")
    return report


def serve_phase(torch, dev, kernels) -> dict:
    from alphatriangle_tpu_torch.config import AlphaTriangleMCTSConfig, EnvConfig, ModelConfig
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.nn import NeuralNetwork
    from alphatriangle_tpu_torch.serving import PolicyService, run_simulated_load

    slots, sims = 64, 64
    env_cfg, model_cfg = EnvConfig(), ModelConfig()
    mcts_cfg = AlphaTriangleMCTSConfig(max_simulations=sims)
    env = TriangleEnv(env_cfg, device=dev)
    extractor = FeatureExtractor(env, model_cfg)
    net = NeuralNetwork(model_cfg, env_cfg, seed=0, device=dev)
    mcts = BatchedMCTS(env, extractor, net.model, mcts_cfg, net.support)
    if (mcts.wave_size, mcts.num_waves, mcts_cfg.max_depth) != (32, 2, 8):
        fail(f"unexpected search shape W={mcts.wave_size} waves={mcts.num_waves}")
    service = PolicyService(env, extractor, net, mcts, slots=slots, rng_seed=0)
    checked = {"dispatches": 0, "answered": 0}
    real_dispatch = service.dispatch

    def dispatch_checked(*args, **kwargs):
        pending = set(service._queue)
        states = service.sessions.states
        valid = env.valid_action_mask(states).cpu()
        done = states.done.cpu()
        results = real_dispatch(*args, **kwargs)
        if {r["sid"] for r in results} != pending or len(results) != len(pending):
            fail("a dispatch left a request unanswered")
        for r in results:
            if done[r["slot"]] or not valid[r["slot"], r["action"]]:
                fail(f"served action {r['action']} is not valid for lane {r['slot']}")
        out = service.last_output
        live = ~done.to(dev)
        for name in ("visit_counts", "root_value", "root_prior"):
            if not bool(torch.isfinite(getattr(out, name)).all()):
                fail(f"search output {name} is not finite")
        if not bool((out.visit_counts.sum(dim=-1)[live] == sims).all()):
            fail("a live lane's root visits do not sum to the simulation budget")
        if not all(map(lambda r: abs(r["score"]) < 1e9 and abs(r["reward"]) < 1e9, results)):
            fail("non-finite served reward or score")
        checked["dispatches"] += 1
        checked["answered"] += len(results)
        return results

    service.dispatch = dispatch_checked
    for kern in kernels.values():
        kern.launches = 0
    stats = run_simulated_load(
        service,
        total_sessions=96,
        concurrency=slots,
        max_moves=200,
        seed=0,
        max_dispatches=SERVE_DISPATCHES,
    )
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    n_disp = stats["dispatches"]
    if n_disp != SERVE_DISPATCHES or checked["dispatches"] != n_disp:
        fail(f"expected {SERVE_DISPATCHES} dispatches, ran {n_disp}")
    if checked["answered"] != stats["moves_served"] or stats["moves_served"] == 0:
        fail("served move count disagrees with the answered requests")
    per_dispatch = {"gather_rows": 16, "backup_update": 2}
    for name, want in per_dispatch.items():
        if launches[name] != want * n_disp:
            fail(f"{name}: {launches[name]} launches in {n_disp} dispatches, want {want} each")
    batch_s = sum(service.batch_ms) / 1e3
    report = {
        "launches": launches,
        "dispatches": n_disp,
        "moves_served": stats["moves_served"],
        "dispatch_ms_p50": statistics.median(service.batch_ms),
        "dispatch_ms_first": service.batch_ms[0],
        "moves_per_s": stats["moves_served"] / batch_s,
        "leaf_evals_per_s": slots * sims * n_disp / batch_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    report["profile"] = profile_dispatch(torch, service, report["dispatch_ms_p50"])
    return report


STAGES = (
    "search.init_tree", "search.descend", "search.expand", "search.evaluate",
    "search.backup", "serve.step", "serve.fetch",
)


def profile_dispatch(torch, service, dispatch_ms: float) -> dict:
    """One more full dispatch under `torch.profiler`, after the counted
    run: the device time of its kernels and copies, the kernels that
    took the most, and each labelled stage's host and device time. The
    busy share divides the device time by the unprofiled dispatch time
    (the profiler slows the host, not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from alphatriangle_tpu_torch import rng

    keys = torch.arange(service.sessions.free_count)
    for s in service.open_sessions(rng.fold_in(rng.PRNGKey(7), keys)):
        service.request_move(s.sid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = service.dispatch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if len(results) != service.sessions.slots:
        fail("the profiled dispatch did not serve every slot")
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.key not in STAGES
        and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    stages = {name: {"host_ms": 0.0, "device_ms": 0.0, "calls": 0} for name in STAGES}
    for e in prof.events():
        if e.name in stages and e.device_type == DeviceType.CPU:
            st = stages[e.name]
            st["host_ms"] += e.cpu_time_total / 1e3
            st["device_ms"] += e.device_time_total / 1e3
            st["calls"] += 1
    device_ms = sum(r[1] for r in rows)
    # The ported kernels launch through ctypes, outside any torch op, so
    # the stage labels do not see them; read them by kernel name.
    ported = {
        kname: {
            "ms": sum(ms for k, ms, _ in rows if f"{kname}_kernel" in k),
            "count": sum(c for k, _, c in rows if f"{kname}_kernel" in k),
        }
        for kname in ("gather_rows", "backup_update")
    }
    # A profiler that recorded no device activity measured nothing.
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms if rows else None,
        "device_busy_share": device_ms / dispatch_ms if rows else None,
        "device_launches": sum(r[2] for r in rows),
        "stages": stages,
        "ported": ported,
        "top": [{"name": k[:80], "ms": ms, "count": c} for k, ms, c in rows[:10]],
    }


class _ExactStub:
    """Zero policy logits and value logits that select one atom per
    state (from the occupied-cell count), so both devices compute the
    net's outputs exactly."""

    def __init__(self, atoms: int):
        self.atoms = atoms

    def __call__(self, grid, other):
        import torch

        count = grid[:, 0].clamp(min=0).sum(dim=(-2, -1)).long()
        atom = (count * 3 + 1) % self.atoms
        value = torch.full((grid.shape[0], self.atoms), float("-inf"), device=grid.device)
        value[torch.arange(grid.shape[0], device=grid.device), atom] = 0.0
        return torch.zeros((grid.shape[0], 12), device=grid.device), value


def reference_phase(torch, dev) -> None:
    from alphatriangle_tpu_torch import rng
    from alphatriangle_tpu_torch.config import (
        AlphaTriangleMCTSConfig,
        EnvConfig,
        ModelConfig,
        expected_other_features_dim,
    )
    from alphatriangle_tpu_torch.env import TriangleEnv
    from alphatriangle_tpu_torch.features import FeatureExtractor
    from alphatriangle_tpu_torch.mcts import BatchedMCTS
    from alphatriangle_tpu_torch.nn.model import value_support

    env_cfg = EnvConfig(
        ROWS=3, COLS=4, PLAYABLE_RANGE_PER_ROW=[(0, 4)] * 3, NUM_SHAPE_SLOTS=1,
        MAX_SHAPE_TRIANGLES=3, LINE_MIN_LENGTH=3,
    )
    model_cfg = ModelConfig(
        OTHER_NN_INPUT_FEATURES_DIM=expected_other_features_dim(env_cfg), NUM_VALUE_ATOMS=11
    )
    mcts_cfg = AlphaTriangleMCTSConfig(
        max_simulations=16, max_depth=5, mcts_batch_size=8, dirichlet_epsilon=0.0
    )
    outs = {}
    for device in ("cpu", dev):
        env = TriangleEnv(env_cfg, device=device)
        mcts = BatchedMCTS(
            env, FeatureExtractor(env, model_cfg), _ExactStub(11), mcts_cfg,
            value_support(model_cfg),
        )
        roots = env.reset(rng.split(rng.PRNGKey(4), 16))
        out = mcts.search(roots, rng.PRNGKey(5))
        outs[device] = (out.visit_counts.cpu(), out.root_value.cpu())
    if not torch.equal(outs["cpu"][0], outs[dev][0]):
        fail("search visit counts on the card differ from the CPU's")
    if not torch.allclose(outs["cpu"][1], outs[dev][1], atol=1e-5, rtol=1e-5):
        fail("search root values on the card differ from the CPU's")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    if not (ROOT / "alphatriangle_tpu_torch" / "csrc").is_dir():
        fail(f"the port's sources are not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    from alphatriangle_tpu_torch.ops import KERNELS
    from alphatriangle_tpu_torch.ops._cuda import build_all

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    build_s = build_all(list(KERNELS.values()))
    say(f"kernel build: {build_s:.1f} s for {', '.join(KERNELS)}")
    for kern in KERNELS.values():
        for line in kern.log.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"  ptxas {kern.name}: {line.strip()}")

    rate = hbm_rate(kind)
    t0 = time.perf_counter()
    kreport = kernel_phase(torch, dev, rate)
    for kr in kreport.values():
        say(
            f"kernel {kr['name']}: equal to plain; {kr['ms'] * 1e3:.1f} us "
            f"(plain {kr['plain_ms'] * 1e3:.1f} us, library {kr['library_ms'] * 1e3:.1f} us, "
            f"bound {kr['bound_ms'] * 1e3:.2f} us by {kr['bound_by']}) [{card}]"
        )
    say(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    sreport = serve_phase(torch, dev, KERNELS)
    say(
        f"serve: {sreport['dispatches']} dispatches, {sreport['moves_served']} moves; "
        f"dispatch p50 {sreport['dispatch_ms_p50']:.1f} ms (first {sreport['dispatch_ms_first']:.1f} ms), "
        f"{sreport['moves_per_s']:.1f} moves/s, {sreport['leaf_evals_per_s']:.0f} leaf evals/s, "
        f"peak {sreport['peak_mem_gb']:.2f} GiB; launches {sreport['launches']} [{card}]"
    )
    prof = sreport["profile"]
    if prof["device_ms"] is None:
        say(f"profiled dispatch: wall {prof['wall_ms']:.1f} ms, device time not measured [{card}]")
    else:
        say(
            f"profiled dispatch: wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} "
            f"ms in {prof['device_launches']} kernels and copies, device busy "
            f"{prof['device_busy_share']:.1%} of the p50 dispatch [{card}]"
        )
    for stage, st in prof["stages"].items():
        say(f"  stage {stage}: host {st['host_ms']:.1f} ms, device {st['device_ms']:.1f} ms, "
            f"{st['calls']} calls")
    for kname, st in prof["ported"].items():
        say(f"  ported kernel {kname}: device {st['ms']:.3f} ms in {st['count']} launches")
    for row in prof["top"]:
        say(f"  {row['ms']:8.3f} ms  x{row['count']:<5d} {row['name']}")
    say(f"serve phase: {time.perf_counter() - t0:.1f} s")

    reference_phase(torch, dev)
    say("reference: card search equals the CPU search on a small input")

    kernels_line = []
    for kname, kr in kreport.items():
        entry = {key: kr[key] for key in (
            "name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms",
        )}
        entry["launches"] = sreport["launches"][kname]
        kernels_line.append(entry)
    say(json.dumps({"kernels": kernels_line, "serve": sreport, "card": card}))
    say(card)
    say("kernels: " + ", ".join(KERNELS))
    say(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
