"""Multi-pod dry-run: count every (arch x shape) on the production mesh and
report memory / cost / collective analyses (port of ``repro.launch.dryrun``).

Each pair runs as one device of the mesh would, on a fake process group
of ``prod(mesh)`` ranks with fake tensors (``launch.lowering``): nothing is
allocated on any device, so this runs on the CPU; the numbers model an
NVIDIA H100 (``launch.analysis``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out dryrun.jsonl]
"""
import argparse
import json
import sys
import time
import traceback


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs + shapes (test harness)")
    ap.add_argument("--mesh", default=None,
                    help="override mesh, e.g. '2,4' => (data=2, model=4)")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--opts", default=None, help="JSON dict of lowering opts")
    ap.add_argument("--no-cost-probe", action="store_true",
                    help="count the whole step as it is: every client "
                         "chunk, every layer")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.lowering import lower_pair
    from repro_torch.launch.mesh import make_mesh_compat, make_production_mesh

    def get_mesh(multi_pod):
        if args.mesh:
            dims = tuple(int(x) for x in args.mesh.split(","))
            names = ("pod", "data", "model")[-len(dims):]
            return make_mesh_compat(dims, names)
        return make_production_mesh(multi_pod=multi_pod)

    pairs = []
    archs = [args.arch] if args.arch else list(registry.ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    for a in archs:
        for s in shapes:
            pairs.append((a, s))
    if not (args.all or args.arch or args.shape):
        ap.error("pass --arch/--shape or --all")

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    opts = json.loads(args.opts) if args.opts else {}
    failures = 0
    sink = open(args.out, "a") if args.out else None
    for multi_pod in meshes:
        mesh = get_mesh(multi_pod)
        for arch, shape in pairs:
            t0 = time.time()
            try:
                res = lower_pair(arch, shape, mesh, reduced=args.reduced,
                                 opts=dict(opts),
                                 cost_probe=not args.no_cost_probe)
                res["lower_compile_s"] = round(time.time() - t0, 2)
                status = "SKIP" if "skipped" in res else "OK"
            except Exception as e:  # a failure here is a bug in the system
                failures += 1
                res = {"arch": arch, "shape": shape,
                       "mesh": dict(mesh.shape), "error": str(e),
                       "traceback": traceback.format_exc()}
                status = "FAIL"
            line = json.dumps(res)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            r = res.get("roofline", {})
            mem = res.get("memory", {})
            print(f"[{status}] {arch} x {shape} mesh={dict(mesh.shape)} "
                  f"({res.get('lower_compile_s', 0)}s) "
                  f"flops/dev={r.get('flops_per_device', 0):.3e} "
                  f"coll={r.get('collectives', {}).get('total_wire_bytes', 0):.3e}B "
                  f"peak={mem.get('peak_bytes_est', 0) / 2**30:.2f}GiB "
                  f"dom={r.get('dominant', '-')}", flush=True)
            if status == "FAIL":
                print(res["traceback"], file=sys.stderr)
    if sink:
        sink.close()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
