#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s) with its seconds:
  1. card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: both CUDA kernels from move2hear_tpu_torch/csrc/ (nvcc, in
     parallel), with ptxas registers and spills;
  3. kernels at the eval path's shapes (16 envs): max abs error against the
     plain PyTorch version on the card, kernel and plain device times (CUDA
     events around CUDA-graph replays over inputs that overflow the L2), the
     per-call time when issued from Python, and the least time the card's
     memory rate allows;
  4. slice: ``move2hear_tpu_torch.main --run-type eval`` with
     configs/test/nearTarget.yaml at full width (hidden 512, 64 micro-scene
     episodes, 16 envs, seeded random weights), cold then warm; the launch
     counters must read 160 and 400 after the run;
  5. parity: a short eval on the card (TF32 off) against the same eval on
     the CPU's plain path: equal deterministic actions, STFT-L2 and SI-SDR
     within tolerance;
  6. one JSON line {"kernels": [...]}, then the last line
     {"ok": true, "device": {...}}.
Any failure exits non-zero before the last line. Without a GPU, or without
the package beside this file, it fails at once.
"""

import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 * 2**20       # H100 SXM L2 cache
KERNEL_TOL = 1e-5           # float32 elementwise math, same formulas as plain
REPLACES = {
    "masked_mix_slice16": "move2hear_tpu/ops/pallas_kernels.py:85",
    "overlap_add": "move2hear_tpu/ops/pallas_kernels.py:186",
}
PATH_LAUNCHES = {"masked_mix_slice16": 160, "overlap_add": 400}


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, t0: float, detail: str):
    print(f"[{name}] {detail} ({time.perf_counter() - t0:.3f} s)", flush=True)


def eager_ms(fn, n: int = 200) -> float:
    """Per-call time of `fn` issued from Python: host launch cost included."""
    import torch

    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, inputs, n: int = 100, reps: int = 5) -> float:
    """Device time per call of ``fn(*args)``: `n` calls captured in one CUDA
    graph and replayed, so host launch cost drops out. The calls rotate over
    `inputs`, copies that together overflow the L2 cache, and keep their
    outputs, so each call reads and writes HBM as `bound_ms` assumes."""
    import torch

    fn(*inputs[0])
    torch.cuda.synchronize()
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(n):
            outs.append(fn(*inputs[i % len(inputs)]))
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def l2_cold_copies(*tensors):
    """Copies of `tensors`, enough that together they take twice the L2."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(t.clone() for t in tensors) for _ in range(math.ceil(2 * L2_BYTES / nbytes))]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def kernel_phase(torch, kernels, F):
    """Phase 3: error, times and bound of each kernel at the path's shapes."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    mix = torch.tensor(np.abs(rng.standard_normal((16, 512, 32, 2))), dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.uniform(-0.5, 1.5, (16, 512, 32, 2)), dtype=torch.float32, device=dev)
    frames = torch.tensor(rng.standard_normal((16, 32, 1023)), dtype=torch.float32, device=dev)
    win, inv_env = kernels.ola_tables(1023, 512, 32, str(dev))
    out_len = 1023 + 512 * 31

    mm_bytes = 3 * mix.numel() * 4                      # 2 inputs read, 1 output written
    mm_ops = 4 * mix.numel()                            # expm1, mul, max, log1p
    ola_bytes = (frames.numel() + win.numel() + inv_env.numel() + 16 * out_len) * 4
    ola_ops = 2 * frames.numel() + 16 * out_len         # window mul + add, envelope mul
    plain_ola = functools.partial(kernels.overlap_add_plain, win=win, inv_env=inv_env, hop=512)
    cases = {  # kernel, plain version, inputs, bytes, operations
        "masked_mix_slice16": (
            kernels.masked_mix_slice16, kernels.masked_mix_slice16_plain,
            (mix, mask), mm_bytes, mm_ops,
        ),
        "overlap_add": (kernels.overlap_add, plain_ola, (frames,), ola_bytes, ola_ops),
    }
    rows = {}
    for name, (kern, plain, args, nbytes, nops) in cases.items():
        t0 = time.perf_counter()
        err = float((kern(*args) - plain(*args)).abs().max())
        torch.cuda.synchronize()
        if not err <= KERNEL_TOL:
            fail(f"{name}: max abs error {err} against the plain version > {KERNEL_TOL}")
        copies = l2_cold_copies(*args)
        ms, plain_ms = device_ms(kern, copies), device_ms(plain, copies)
        eager, eager_plain = eager_ms(lambda: kern(*args)), eager_ms(lambda: plain(*args))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"move2hear_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # no one PyTorch call computes either function
            "library_ms": None,
        }
        extra = ""
        if name == "overlap_add":
            # F.fold sums the frames: the overlap-add without window and envelope
            fold_ms = device_ms(
                lambda fr: F.fold(fr.transpose(1, 2), (1, out_len), (1, 1023), stride=(1, 512)),
                copies,
            )
            extra = f"; F.fold sum alone (no window, no envelope) {fold_ms * 1e3:.2f} us"
        phase("kernel", t0, (
            f"{name}: max_abs_err {err:.3e} (tol {KERNEL_TOL}); B=16 kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
            f"{rows[name]['bound_ms'] * 1e3:.2f} us ({rows[name]['bound_by']}, {nbytes} B){extra}; "
            f"device times from CUDA-graph replay over {len(copies)} input copies (L2-cold); "
            f"issued from Python {eager * 1e3:.2f} us, plain {eager_plain * 1e3:.2f} us per call"
        ))
    return rows


def slice_phase(torch, kernels, card, run_dir):
    """Phase 4: the eval CLI at full width, cold then warm."""
    from move2hear_tpu_torch.config import get_config
    from move2hear_tpu_torch.main import main as port_main
    from move2hear_tpu_torch.models import Move2HearPolicy
    from move2hear_tpu_torch.utils.checkpoint import save_checkpoint

    exp = os.path.join(REPO, "configs", "test", "nearTarget.yaml")
    cfg = get_config(exp, [], run_dir, "eval")
    torch.manual_seed(SEED)
    policy = Move2HearPolicy(
        num_actions=len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS), hidden_size=cfg.RL.PPO.hidden_size,
        extra_rgb=cfg.EXTRA_RGB, extra_depth=cfg.EXTRA_DEPTH, use_ddppo=cfg.RL.PPO.use_ddppo,
    )
    ckpt = os.path.join(run_dir, "ckpt.0.pt")
    save_checkpoint(ckpt, {"state_dict": policy.state_dict(), "config": cfg.to_dict()})
    argv = ["--run-type", "eval", "--exp-config", exp, "--model-dir", run_dir,
            "EVAL_CKPT_PATH_DIR", ckpt]
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        trainer = port_main(argv)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        wall = time.perf_counter() - t0
        agg, tm = trainer.last_eval
        if counts != PATH_LAUNCHES:
            fail(f"main-path kernel launches {counts}, expected {PATH_LAUNCHES}")
        phase("slice", t0, (
            f"run {run}: {tm['episodes'] / tm['loop_s']:.3f} episodes/s, "
            f"{tm['env_steps'] / tm['loop_s']:.1f} env-steps/s over the episode loop "
            f"({tm['loop_s']:.3f} s), set-up {tm['setup_s']:.3f} s, "
            f"end to end {tm['env_steps'] / wall:.1f} env-steps/s ({card})"
        ))
    for k in ("mono_l2_last", "mem_l2_last", "mono_si_sdr_last", "monoFromMem_si_sdr_last"):
        if k not in agg or not all(math.isfinite(v) for v in agg[k].values()):
            fail(f"aggregate {k} missing or not finite: {agg.get(k)}")
    stats = os.path.join(run_dir, f"{cfg.EVAL.SPLIT}_stats_ckpt_0_{cfg.SEED}.json")
    if not os.path.exists(stats) or tm["episodes"] != 64:
        fail(f"eval wrote no {stats} or played {tm['episodes']} episodes, not 64")
    print("slice aggregates: " + ", ".join(
        f"{k} {agg[k]['mean']:.6f}" for k in
        ("mono_l2_last", "mem_l2_last", "bin_l2_all", "mono_si_sdr_last", "monoFromMem_si_sdr_last")
    ), flush=True)
    print(f"main-path launches: {counts}", flush=True)
    return counts


def parity_phase(torch):
    """Phase 5: the same short deterministic eval on the card and on the CPU."""
    import numpy as np

    import move2hear_tpu_torch.env.device_env as de
    from move2hear_tpu_torch.env.micro_scene import build_micro_scene
    from move2hear_tpu_torch.eval.device_evaluator import make_device_eval
    from move2hear_tpu_torch.models import Move2HearPolicy

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_envs, steps = 8, 5
    bundle = build_micro_scene(rows=3, cols=3, num_episodes=n_envs, rir_length=4000)
    torch.manual_seed(SEED + 1)
    weights = Move2HearPolicy(3, 512, extra_depth=True, use_ddppo=True).state_dict()
    outs = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        policy = Move2HearPolicy(3, 512, extra_depth=True, use_ddppo=True)
        policy.load_state_dict(weights)
        policy = policy.to(dev).eval()
        bank = de.build_device_bundle(bundle, dev, precompute_rir_rfft=True)
        fn = make_device_eval(policy, policy, steps, 1.2, (1, 2, 3), True,
                              compute_waveform_metrics=True)
        order = torch.arange(n_envs, device=dev)[:, None]
        with torch.inference_mode():
            _, _, o = fn(bank, de.env_reset_all(bank.scene, bank.episodes, order), None)
        outs[name] = {k: v.cpu().numpy() for k, v in o.items()}
    g, c = outs["cuda"], outs["cpu"]
    if not np.array_equal(g["action"], c["action"]):
        fail(f"parity: actions differ: cuda {g['action'].tolist()} cpu {c['action'].tolist()}")
    rel = max(float(np.max(np.abs(g[k] - c[k]) / np.abs(c[k]))) for k in ("mono_l2", "mem_l2", "bin_l2"))
    if not rel <= 1e-4:
        fail(f"parity: per-step STFT-L2 relative error {rel} > 1e-4")
    si_g, si_c = g["si_mono"][..., 0], c["si_mono"][..., 0]
    ok = si_c > -40.0  # below -40 dB the metric is ill-conditioned
    si_err = float(np.max(np.abs(si_g - si_c)[ok])) if ok.any() else 0.0
    if not si_err <= 0.05:
        fail(f"parity: SI-SDR differs by {si_err} dB > 0.05 dB")
    phase("parity", t0, (
        f"cuda vs cpu over ({steps}, {n_envs}) (steps, envs): actions equal; per-step "
        f"STFT-L2 max rel err {rel:.3e} (tol 1e-4); SI-SDR max abs diff {si_err:.4f} dB "
        f"over {int(ok.sum())} entries above -40 dB (tol 0.05)"
    ))


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(REPO, "move2hear_tpu_torch")):
        fail(f"no move2hear_tpu_torch package beside {__file__}")
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from move2hear_tpu_torch.ops import build, kernels

    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    try:
        import yaml  # noqa: F401
        has_yaml = True
    except ImportError:
        has_yaml = False
    phase("card", t0, (
        f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; yaml importable: {has_yaml}"
    ))

    t0 = time.perf_counter()
    for name in build.SIGNATURES:
        lib = build.library_path(name)
        if os.path.exists(lib):
            os.remove(lib)  # always build from the checkout's sources
    secs = build.build_all()
    for name in build.SIGNATURES:
        build.load(name)
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    phase("build", t0, f"{len(build.SIGNATURES)} kernels built by nvcc in {secs:.2f} s")

    rows = kernel_phase(torch, kernels, F)
    run_dir = os.path.join(REPO, "_smoke_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    try:
        launches = slice_phase(torch, kernels, card, run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    parity_phase(torch)

    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
