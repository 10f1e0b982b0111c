"""Hold the port's training loop to the JAX package's at the training
script's length, on the CPU, in f32: the held-out IoU of what each loop
ships.

    python scripts/torch_train_parity.py [--seed S] [--steps N] [--fresh]
        [--perturb] [--evaluate] [--witness SETS] [--out-dir DIR]

From one ``--seed`` the JAX loop (as ``scripts/train_flagship.py`` builds
it: ``init_params(PRNGKey(0), in_channels=2, size=128)``, the bundled
weights unless ``--fresh``, ``optax.adamw(cosine_decay_schedule(peak, N,
0.05))`` at peak 5e-4 resumed or 2e-3 fresh, batches of 8 at 128^2) and the
port's loop (as ``scripts/torch_train_flagship.py`` builds it, from the
same initial values) take the same numpy batch each step, rendered once by
the JAX package's ``synthetic_batch``; both models are f32. Every 25 steps
it prints both losses and the largest relative distance of a parameter
tensor from JAX's, elementwise and in L2. At the end it writes both f16
checkpoints under ``--out-dir`` (``build/train_parity`` by default; never
the bundled path) and prints the held-out IoU (plain, budding, nuclei; the
fixed renders of seed 987654 that ``train_flagship.py`` ``heldout_iou``
draws, 6 images a set) four ways, each package's engine (flow-error QC
0.4) on each checkpoint, and, resumed, on the bundled weights (the
incumbent); with each engine's U-Net in f32 and in bf16 (the engines'
default, which ``train_flagship.py`` uses).

The rule, held on the f32 engines: on each set, each of the port's engine
on the port's checkpoint, the JAX engine on the port's and the port's
engine on the JAX checkpoint is within max(0.005, the chaos floor) of the
JAX engine on the JAX checkpoint; the port's engine on the bundled weights
is within 0.005 of JAX's engine on them. 0.005 is the reference script's
acceptance margin. The chaos floor is how far JAX's own held-out IoU moves
when its initial parameters move by one ulp: ``--perturb`` trains both
loops from parameters moved one ulp up (the port's run is another sample
of its own spread), and the floor is the distance of the moved JAX run's
held-out IoU from the unmoved one's, per set, once both runs of the same
seed, N and start are on disk (the second of the two prints it, and the
rule with it). In f32 the two engines are one function (the same labels,
bit for bit), so the rule sees the checkpoints alone. In bf16 they are
not, and the bf16 results are printed and kept, not held: the
convolutions sum in each framework's order, and XLA:CPU skips some of the
bf16 roundings the Flax model writes (``xla_allow_excess_precision``), so
no output element of the two bf16 forwards is equal, and on a set the
model segments poorly the labels differ by whole objects.

``--witness SETS`` (after a run and its ``--perturb`` run) measures
whether that bf16 gap is rounding: each bf16 U-Net's error against an f64
forward (JAX's compiled both ways), and the bf16 gaps over SETS held-out
sets beside JAX's own one-ulp spread and JAX's gap from itself compiled
with every rounding.

``--evaluate`` evaluates the checkpoints of a run on disk again (no
training). Each run writes its numbers as JSON beside the checkpoints; the
exit code is 1 when the rule is missed.

Both packages are imported here; neither imports this script. It never
runs ``scripts/train_flagship.py`` (whose seed follows the clock and which
writes the bundled checkpoint).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

MARGIN = 0.005  # scripts/train_flagship.py's acceptance margin on each held-out set
SETS = ("plain", "budding", "nuclei")
BATCH, SIZE, ALPHA = 8, 128, 0.05
N_HELDOUT = 6  # images a held-out set, as scripts/train_flagship.py draws them
LOG_EVERY = 25
KEEP_BATCHES = 2  # the first batches a run returns, for a loop to be run again on them


def peak_lr(fresh: bool) -> float:
    return 2e-3 if fresh else 5e-4


def jax_start(fresh: bool, perturb: bool = False):
    """The JAX model (f32) and its initial parameters, moved one ulp up
    with ``perturb``. Resumed, the bundled weights are read into the tree
    the port's ``flax_from_params`` lays out (Flax's; its values unused),
    which spares Flax's eager initialisation at full width."""
    import jax
    import jax.numpy as jnp
    import torch

    from aliby_tpu.models import training as JT
    from aliby_tpu.models.segment import BUNDLED_WEIGHTS
    from aliby_tpu.models.unet import CellposeNet, init_params
    from aliby_tpu_torch.models.unet import init_params as port_init
    from aliby_tpu_torch.models.weights import flax_from_params

    if fresh:
        model, params = init_params(jax.random.PRNGKey(0), in_channels=2, size=SIZE,
                                    dtype=jnp.float32)
    else:
        model = CellposeNet(dtype=jnp.float32)
        template = flax_from_params(port_init(0, in_channels=2, device="cpu",
                                              dtype=torch.float32).state_dict())
        params = JT.load_params(BUNDLED_WEIGHTS, template)
    if perturb:
        params = jax.tree_util.tree_map(
            lambda p: jnp.asarray(np.nextafter(np.asarray(p, np.float32), np.float32(np.inf))),
            params)
    return model, params


def port_start(jax_params, check_bundled: bool):
    """The port's model (f32, on the CPU) from the JAX loop's initial
    values (fresh, JAX's ``init_params`` draws: the port's generator draws
    other values). With ``check_bundled`` they are the bundled weights,
    and the port's ``load_params`` must read them as JAX's does."""
    import torch

    from aliby_tpu_torch.models import training as PT
    from aliby_tpu_torch.models.unet import init_params
    from aliby_tpu_torch.models.weights import BUNDLED_WEIGHTS, params_from_flax

    model = init_params(0, in_channels=2, size=SIZE, device="cpu", dtype=torch.float32)
    jax_state = params_from_flax(_numpy_tree(jax_params))
    if check_bundled:
        for k, v in PT.load_params(BUNDLED_WEIGHTS, model).items():
            if not torch.equal(v, jax_state[k]):
                raise AssertionError(f"the bundled weights read apart: {k}")
    model.load_state_dict(jax_state)
    return model


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def parameter_distance(port_model, jax_params) -> dict:
    """The largest over tensors of max |p - p_jax| / max |p_jax| (``max``)
    and of ||p - p_jax|| / ||p_jax|| (``l2``; Adam's first step moves each
    element by about the rate whatever its gradient, so where a gradient is
    rounding noise the elementwise distance reads the rate), each with its
    tensor's name."""
    from aliby_tpu_torch.models.weights import params_from_flax

    want = params_from_flax(_numpy_tree(jax_params))
    out = {"max": (0.0, ""), "l2": (0.0, "")}
    for k, v in port_model.state_dict().items():
        w = want[k].numpy().astype(np.float64)
        diff = v.numpy().astype(np.float64) - w
        for what, d in (("max", np.abs(diff).max() / max(np.abs(w).max(), 1e-30)),
                        ("l2", np.linalg.norm(diff) / max(np.linalg.norm(w), 1e-30))):
            if d > out[what][0]:
                out[what] = (float(d), k)
    return out


def train(seed: int, steps: int, fresh: bool, perturb: bool = False) -> dict:
    """Both loops in lockstep on one batch stream, from parameters moved
    one ulp up with ``perturb``. Returns the final JAX parameters, the
    port's model, the per-step losses, the logged distances and the first
    :data:`KEEP_BATCHES` batches."""
    import jax
    import optax
    import torch

    from aliby_tpu.models import training as JT
    from aliby_tpu_torch.models import training as PT

    model_j, params = jax_start(fresh, perturb)
    peak = peak_lr(fresh)
    tx = optax.adamw(optax.cosine_decay_schedule(peak, steps, ALPHA))
    opt_state, step_j = tx.init(params), JT.make_train_step(model_j, tx)
    model_p = port_start(params, check_bundled=not (fresh or perturb))
    opt, scheduler = PT.adamw(model_p.parameters(), PT.cosine_decay_schedule(peak, steps, ALPHA))
    step_p = PT.make_train_step(model_p, opt, scheduler)
    rng = np.random.default_rng(seed)
    losses = {"jax": [], "port": []}
    distances, batches = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = JT.synthetic_batch(rng, BATCH, SIZE)
        if i < KEEP_BATCHES:
            batches.append(batch)
        params, opt_state, want = step_j(params, opt_state, batch)
        losses["jax"].append(float(want["loss"]))
        got = step_p({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        losses["port"].append(float(got["loss"]))
        if (i + 1) % LOG_EVERY == 0 or i == 0 or i + 1 == steps:
            d = parameter_distance(model_p, params)
            distances.append({"step": i + 1, **d})
            rel = abs(losses["port"][-1] - losses["jax"][-1]) / abs(losses["jax"][-1])
            print(f"step {i + 1}/{steps} jax loss {losses['jax'][-1]:.6f}, port "
                  f"{losses['port'][-1]:.6f} (rel {rel:.3g}); largest relative parameter "
                  f"distance: elementwise {d['max'][0]:.3g} ({d['max'][1]}), L2 "
                  f"{d['l2'][0]:.3g} ({d['l2'][1]}) ({time.perf_counter() - t0:.0f} s)",
                  flush=True)
    jax.block_until_ready(params)
    return {"jax_params": params, "port_model": model_p, "losses": losses,
            "distances": distances, "batches": batches, "seconds": time.perf_counter() - t0}


DTYPES = ("f32", "bf16")  # the held engines first


STRICT = {"xla_allow_excess_precision": False}  # XLA keeps every rounding the program writes


def _compiled_with(jitted, options: dict):
    """``jitted`` compiled with the XLA ``options``, once a shape."""
    cache = {}

    def call(params, images):
        if images.shape not in cache:
            cache[images.shape] = jitted.lower(params, images).compile(compiler_options=options)
        return cache[images.shape](params, images)

    return call


class Engines:
    """One engine of each package (flow-error QC 0.4; its U-Net in f32 or
    in bf16, the default), each taking a checkpoint's parameters in turn;
    with ``strict``, JAX's program compiled with :data:`STRICT`."""

    def __init__(self, dtype: str = "f32", strict: bool = False):
        import jax.numpy as jnp
        import torch

        from aliby_tpu.models.segment import CellposeTPU
        from aliby_tpu_torch.models.segment import CellposeTorch

        f32 = dtype == "f32"
        self.jax = CellposeTPU(flow_threshold=0.4,
                               model_kwargs={"dtype": jnp.float32} if f32 else None)
        self.port = CellposeTorch(flow_threshold=0.4, device="cpu",
                                  model_kwargs={"dtype": torch.float32} if f32 else None)
        if strict:
            self.jax._segment_all = _compiled_with(self.jax._segment_all, STRICT)

    def scores(self, engine: str, checkpoint, sets: dict) -> dict:
        from aliby_tpu_torch.models import training as PT

        if engine == "jax":
            from aliby_tpu.models import training as JT

            self.jax.params = JT.load_params(checkpoint, self.jax.params)
            # one image a call, as the reference's gate runs it (XLA compiles
            # a program a batch size)
            return PT.heldout_scores(
                lambda images: [self.jax.segment_tiles(im[None])[0] for im in images], sets)
        from aliby_tpu_torch.models.weights import params_from_flax, read_flax_checkpoint

        self.port.model.load_state_dict(params_from_flax(read_flax_checkpoint(checkpoint)))
        return PT.heldout_scores(self.port.segment_tiles, sets)


def heldout_sets(n: int, seed: int | None = None) -> dict:
    """The held-out renders (``seed`` 987654 by default, the training
    scripts' set), drawn by the JAX package's generators (and the port's,
    which must give the same bits)."""
    from aliby_tpu import test_data as jax_test_data
    from aliby_tpu_torch.models import training as PT

    seed = PT.HELDOUT_SEED if seed is None else seed
    sets = PT.heldout_sets(n, n, test_data=jax_test_data, seed=seed)
    for name, items in PT.heldout_sets(n, n, seed=seed).items():
        for (img, gt), (want_img, want_gt) in zip(items, sets[name]):
            if not (np.array_equal(img, want_img) and np.array_equal(gt, want_gt)):
                raise AssertionError(f"the port renders the held-out {name} set apart")
    return sets


def evaluate(checkpoints: dict, sets: dict, engines: Engines) -> dict:
    """``{"<engine> on <checkpoint>": scores}`` for both engines and every
    checkpoint."""
    return {f"{engine} on {ckpt}": engines.scores(engine, path, sets)
            for engine in ("jax", "port") for ckpt, path in checkpoints.items()}


def rule(iou: dict, floor: dict | None) -> dict:
    """Each trained evaluation's distance from the JAX engine on the JAX
    checkpoint, per set, against max(MARGIN, floor); and the port's engine
    on the bundled weights against JAX's engine on them, against MARGIN."""
    limits = {s: max(MARGIN, (floor or {}).get(s, 0.0)) for s in SETS}
    pairs = [(what, "jax on jax", limits) for what in iou
             if what != "jax on jax" and not what.endswith("bundled")]
    if "port on bundled" in iou:
        pairs.append(("port on bundled", "jax on bundled", dict.fromkeys(SETS, MARGIN)))
    out = {}
    for what, ref, lim in pairs:
        gaps = {s: round(abs(iou[what][s] - iou[ref][s]), 4) for s in SETS}
        out[f"{what} against {ref}"] = {"gaps": gaps, "limits": lim,
                                        "ok": all(gaps[s] <= lim[s] for s in SETS)}
    return out


def commit() -> str | None:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT, check=True,
                              capture_output=True, text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def evaluate_all(checkpoints: dict) -> dict:
    """``{dtype: evaluate(...)}`` over :data:`DTYPES`, printed."""
    sets = heldout_sets(N_HELDOUT)
    out = {}
    for dtype in DTYPES:
        out[dtype] = evaluate(checkpoints, sets, Engines(dtype))
        for what, scores in out[dtype].items():
            print(f"held-out IoU, {dtype} engines, {what}: {scores}", flush=True)
    return out


# -- the bf16 witness -----------------------------------------------------------


def forward_errors(checkpoint, sets: dict) -> dict:
    """Per set and output (flows: channels 0-1; cell logit: channel 2), the
    RMS distance of each bf16 U-Net output from the f64 output, over the
    ``sets``' images as the engines normalise them, relative to the f64
    output's RMS: ``{set: {output: {forward: e}}}``. The forwards: the
    port's (the engine's ``_forward``, its micro-batches); JAX's, jitted
    with the engine's normalisation, one image a call, as its engine runs
    it (``jax``); the same compiled with ``xla_allow_excess_precision``
    off (``jax, every rounding``: XLA then keeps every bf16 rounding the
    Flax model writes; by default XLA:CPU may skip some); and, under
    ``... from port``, the distance of each JAX forward from the port's."""
    import jax
    import jax.numpy as jnp
    import torch

    from aliby_tpu.models import training as JT
    from aliby_tpu.models.segment import _normalize_percentile as jax_normalize
    from aliby_tpu.models.unet import init_params as jax_init
    from aliby_tpu_torch.models.segment import CellposeTorch, _normalize_percentile
    from aliby_tpu_torch.models.unet import forward_f64

    model_j, params = jax_init(jax.random.PRNGKey(0), in_channels=2, size=SIZE)
    params = JT.load_params(checkpoint, params)

    @jax.jit
    def jax_forward(p, images):
        x = jax.vmap(lambda im: jax.vmap(jax_normalize, in_axes=-1, out_axes=-1)(im))(
            images.transpose(0, 2, 3, 1))
        return model_j.apply(p, x)

    strict = _compiled_with(jax_forward, STRICT)
    port = CellposeTorch(pretrained_path=checkpoint, flow_threshold=0.4, device="cpu")
    f32 = CellposeTorch(pretrained_path=checkpoint, device="cpu",
                        model_kwargs={"dtype": torch.float32})
    out = {}
    for name, items in sets.items():
        images = np.stack([img for img, _ in items])
        with torch.no_grad():
            x = _normalize_percentile(torch.from_numpy(images).permute(0, 2, 3, 1))
            want = forward_f64(f32.model, x).numpy()
            got = {"port": port._forward(x).double().numpy()}
            for what, fn in (("jax", jax_forward), ("jax, every rounding", strict)):
                got[what] = np.concatenate([np.asarray(fn(params, im[None]), np.float64)
                                            for im in images])
        out[name] = {}
        for what, ch in (("flows", slice(0, 2)), ("cellprob", slice(2, 3))):
            scale = np.sqrt(np.mean(want[..., ch] ** 2))

            def rms(a, b):
                return float(np.sqrt(np.mean((a[..., ch] - b[..., ch]) ** 2)) / scale)

            out[name][what] = {k: rms(v, want) for k, v in got.items()}
            out[name][what].update({f"{k} from port": rms(got[k], got["port"])
                                    for k in ("jax", "jax, every rounding")})
    return out


def witness(stem: Path, moved: Path, n_sets: int) -> dict:
    """Whether the bf16 engines' held-out gap is rounding: (1) each bf16
    U-Net's error against the f64 forward, on both checkpoints of the run
    at ``stem``; (2) on ``n_sets`` held-out sets (the training scripts'
    first, then seeds 987655, ...), the bf16 engines on both checkpoints,
    and JAX's engine on the checkpoint of the run from parameters moved
    one ulp (``moved``): per set, the port's gap (port on port minus JAX
    on JAX) beside JAX's own one-ulp spread (JAX on the moved checkpoint
    minus JAX on JAX), and the same gaps from JAX's engine compiled with
    :data:`STRICT` (``strict``)."""
    from aliby_tpu_torch.models import training as PT

    checkpoints = {"jax": Path(f"{stem}-jax.msgpack"), "port": Path(f"{stem}-port.msgpack"),
                   "moved": Path(f"{moved}-jax.msgpack")}
    errors = {c: forward_errors(checkpoints[c], heldout_sets(N_HELDOUT))
              for c in ("jax", "port")}
    for c, e in errors.items():
        print(f"bf16 U-Net output's RMS distance from f64, relative, {c} checkpoint: {e}",
              flush=True)
    engines, strict, draws = Engines("bf16"), Engines("bf16", strict=True), []
    gaps = {  # name: (minuend, subtrahend)
        "port gap": ("port on port", "jax on jax"),
        "engine gap on jax": ("port on jax", "jax on jax"),
        "engine gap on port": ("port on port", "jax on port"),
        "jax one-ulp spread": ("jax on moved", "jax on jax"),
        "jax every rounding minus jax": ("strict on jax", "jax on jax"),
        "port gap from jax every rounding": ("port on port", "strict on jax"),
        "engine gap from jax every rounding on port": ("port on port", "strict on port")}
    for k in range(n_sets):
        sets = heldout_sets(N_HELDOUT, PT.HELDOUT_SEED + k)
        iou = {f"{e} on {c}": engines.scores(e, checkpoints[c], sets)
               for e, c in (("jax", "jax"), ("jax", "port"), ("port", "jax"), ("port", "port"),
                            ("jax", "moved"))}
        iou.update({f"strict on {c}": strict.scores("jax", checkpoints[c], sets)
                    for c in ("jax", "port")})
        draw = {"seed": PT.HELDOUT_SEED + k, "iou": iou}
        draw.update({w: {s: round(iou[a][s] - iou[b][s], 4) for s in SETS}
                     for w, (a, b) in gaps.items()})
        draws.append(draw)
        print(f"held-out set of seed {draw['seed']}, bf16 engines: " + "; ".join(
            f"{w} {draw[w]}" for w in gaps), flush=True)
    summary = {}
    for w in gaps:
        summary[w] = {s: {"mean": round(float(np.mean([d[w][s] for d in draws])), 4),
                          "mean_abs": round(float(np.mean([abs(d[w][s]) for d in draws])), 4),
                          "below": sum(d[w][s] < 0 for d in draws),
                          "above": sum(d[w][s] > 0 for d in draws)} for s in SETS}
        print(f"over {n_sets} held-out sets, {w}: {summary[w]}", flush=True)
    return {"forward_errors": errors, "draws": draws, "summary": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="the batch stream's numpy seed")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--fresh", action="store_true",
                    help="start from init_params(PRNGKey(0)) at peak 2e-3")
    ap.add_argument("--perturb", action="store_true",
                    help="both loops from parameters moved one ulp up (the chaos floor)")
    ap.add_argument("--out-dir", type=Path, default=ROOT / "build" / "train_parity")
    ap.add_argument("--evaluate", action="store_true",
                    help="train nothing: evaluate the checkpoints of the run on disk again")
    ap.add_argument("--witness", type=int, metavar="SETS",
                    help="train nothing: the bf16 witness of the run and its --perturb run "
                         "on disk, over SETS held-out sets")
    args = ap.parse_args(argv)

    import torch

    from aliby_tpu.models import training as JT
    from aliby_tpu_torch.models import training as PT
    from aliby_tpu_torch.models.weights import BUNDLED_WEIGHTS

    start = "fresh" if args.fresh else "resumed"
    tag = f"{start}-seed{args.seed}-n{args.steps}"
    stem = args.out_dir / f"{'perturb' if args.perturb else 'parity'}-{tag}"
    if args.witness:
        result = witness(args.out_dir / f"parity-{tag}", args.out_dir / f"perturb-{tag}",
                         args.witness)
        result["commit"] = commit()
        (args.out_dir / f"witness-{tag}.json").write_text(json.dumps(result))
        return 0
    checkpoints = {"jax": Path(f"{stem}-jax.msgpack"), "port": Path(f"{stem}-port.msgpack")}
    if not (args.fresh or args.perturb):  # the incumbent, as the training script scores it
        checkpoints["bundled"] = BUNDLED_WEIGHTS
    if args.evaluate:
        result = json.loads(Path(f"{stem}.json").read_text())
    else:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        print(f"{start}, seed {args.seed}, {args.steps} steps, peak {peak_lr(args.fresh)}"
              f"{', parameters moved one ulp up' if args.perturb else ''}; torch "
              f"{torch.__version__}, {torch.get_num_threads()} threads; commit {commit()}",
              flush=True)
        run = train(args.seed, args.steps, args.fresh, perturb=args.perturb)
        JT.save_params(run["jax_params"], checkpoints["jax"])
        PT.save_params(run["port_model"], checkpoints["port"])
        result = {"seed": args.seed, "steps": args.steps, "start": start, "commit": commit(),
                  "n_heldout": N_HELDOUT, "losses": run["losses"],
                  "distances": run["distances"], "train_s": run["seconds"]}
    t0 = time.perf_counter()
    result["iou"] = evaluate_all(checkpoints)
    result["eval_s"], result["eval_commit"] = time.perf_counter() - t0, commit()
    Path(f"{stem}.json").write_text(json.dumps(result))
    return report(args.out_dir, tag)


def report(out_dir: Path, tag: str) -> int:
    """The chaos floor per engine dtype, once both the unperturbed and the
    perturbed run of ``tag`` are on disk, and the rule on the unperturbed
    run (the margin alone until the floor exists): held on the f32
    engines, printed for the bf16 ones. Returns the exit code: 1 when the
    held rule is missed."""
    base, moved = out_dir / f"parity-{tag}.json", out_dir / f"perturb-{tag}.json"
    floor = None
    if base.exists() and moved.exists():
        ref = json.loads(base.read_text())["iou"]
        got = json.loads(moved.read_text())["iou"]
        floor = {d: {s: round(abs(got[d]["jax on jax"][s] - ref[d]["jax on jax"][s]), 4)
                     for s in SETS} for d in DTYPES if d in got and d in ref}
        (out_dir / f"floor-{tag}.json").write_text(json.dumps(floor))
        print(f"chaos floor (|JAX from parameters moved one ulp - JAX|, per set): {floor}",
              flush=True)
    if not base.exists():
        print(f"no unperturbed run at {base} yet", flush=True)
        return 0
    result = json.loads(base.read_text())
    result["floor"] = floor
    result["rule"] = {d: rule(result["iou"][d], (floor or {}).get(d)) for d in DTYPES}
    base.write_text(json.dumps(result))
    ok = True
    for d in DTYPES:
        for what, r in result["rule"][d].items():
            verdict = ("within" if r["ok"] else "MISSED") if d == "f32" else (
                "within" if r["ok"] else "beyond") + " (bf16: reported, not held)"
            print(f"rule, {d} engines, {what}: gaps {r['gaps']} limits {r['limits']} -> "
                  f"{verdict}", flush=True)
            ok &= r["ok"] or d != "f32"
    if floor is None:
        print("(no perturbed run of this seed, N and start on disk: the limits are the "
              "margin alone)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())

