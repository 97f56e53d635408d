"""Times the phases inside K4's and K2's cluster forms on the card, at
the transformer leaf rows (K, 253,755,392), K = 4 and 1, k = 2,537,554
(``topk(r=0.01)``).

A cluster form is one launch, so CUDA events cannot split it. This
script copies ``csrc/topk.cu``, ``csrc/quant.cu`` and ``csrc/cluster.cuh``
into ``build/codec_phases/``, inserts a ``%globaltimer`` stamp written by
thread 0 of every CTA at each phase boundary (after a barrier, so the
whole CTA is past it), builds them with ``nvcc`` into a library of their
own and launches them through the same C entry points as the port. A
phase's time is the mean over the CTAs of the stamp after it less the
stamp before it (the max beside it); the launch's own time is taken by
CUDA events around it. The kernels' sources in the package are not
changed.

K4 (the survivors and the patterns in device memory at these rows): the
slab's load, four radix passes, the compaction (the fifth pass over x),
the sort, the rank against the peers' runs, the read-out and the last
rendezvous. K2 (the streaming form): the absmax pass, the cluster's
exchange of the absmax, the quantize-and-pack pass.

    python src/repro_torch/bench/codec_phases.py   # on the card, ~1 min

Prints one JSON line per (kernel, shape).
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, os.path.join(ROOT, "src"))

LEAF = 22 * 2048 * 5632          # tinyllama's largest leaf
SHAPES = ((4, LEAF), (1, LEAF))
REPS = 3

STAMP = ("if (threadIdx.x == 0 && g_stamps) g_stamps[(size_t)blockIdx.x * 16 "
         "+ {p}] = stamp_now();")
HEADER = """
namespace {
__device__ unsigned long long* g_stamps = nullptr;
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
}  // namespace
extern "C" int NAME_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
"""
# (anchor, text inserted before it); each anchor must occur exactly once
TOPK_EDITS = (
    ("  // -- 1. the slab's patterns", "{s0}\n"),
    ("  // -- 2. radix select of T over the cluster", "{s1}\n"),
    ("    mask |= 0xFFu << shift;\n    __syncthreads();\n",
     None),                                       # after it: a pass's end
    ("  int pw = 2;\n", "{s6}\n"),
    ("  if (DEV) __threadfence();           // the run, in device memory",
     "{s7}\n"),
    ("  // -- 5. read out", "{s8}\n"),
    ("  if (rank == 0 && tid == 0) thr[row] = __uint_as_float(T);",
     "__syncthreads();\n{s9}\n"),
    ("  cluster::wait();    // no CTA leaves while a peer may still read its "
     "keys\n", None),                             # after it: the end
)
QUANT_EDITS = (
    ("  // -- 1. one read of this CTA's elements", "{s0}\n"),
    ("  // -- 3. the row's absmax: each CTA sends its own to every peer",
     "{s1}\n"),
    ("  // -- 4. the scale, the codes, whole bytes", "{s2}\n"),
    ("  if (rank == 0 && threadIdx.x == 0) scales[k] = s;",
     "__syncthreads();\n{s3}\n"),
)
TOPK_PHASES = ("load", "radix pass 1", "radix pass 2", "radix pass 3",
               "radix pass 4", "compaction", "sort", "rank", "read-out",
               "last rendezvous")
QUANT_PHASES = ("absmax pass", "absmax exchange", "quantize-and-pack pass")


def stamps(n: int) -> dict:
    return {f"s{p}": STAMP.format(p=p) for p in range(n)}


def patch(src: str, edits, name: str) -> str:
    out = src
    for anchor, text in edits:
        assert out.count(anchor) == 1, anchor
        if text is None:          # a stamp right after the anchor
            continue
        out = out.replace(anchor, text + anchor)
    if name == "topk":
        pass_end = edits[2][0]
        out = out.replace(pass_end, pass_end + "    " + STAMP.format(
            p="2 + pass") + "\n")
        end = edits[-1][0]
        out = out.replace(end, end + "  " + STAMP.format(p=10) + "\n")
    marker = "namespace {\n"
    at = out.index(marker)
    head = HEADER.replace("NAME", name)
    return out[:at] + head + out[at:]


def build(work: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    os.makedirs(work, exist_ok=True)
    csrc = str(_build.CSRC)
    with open(os.path.join(csrc, "cluster.cuh")) as f:
        cl = f.read()
    with open(os.path.join(work, "cluster.cuh"), "w") as f:
        f.write(cl)
    objs = []
    for name, edits, n in (("topk", TOPK_EDITS, 11),
                           ("quant", QUANT_EDITS, 4)):
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            src = f.read()
        text = patch(src, edits, name)
        for key, val in stamps(n).items():
            text = text.replace("{" + key + "}", val)
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        obj = os.path.join(work, f"{name}.o")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", path, "-o",
                        obj], check=True, capture_output=True, text=True)
        objs.append(obj)
    lib = os.path.join(work, "libphases.so")
    subprocess.run([_build._nvcc(), "-shared", "-o", lib, *objs], check=True)
    return ctypes.CDLL(lib)


def phase_times(torch, st, n_phases: int) -> dict:
    """Mean and max over the CTAs of each phase's time, in ms."""
    d = (st[:, 1:n_phases + 1] - st[:, :n_phases]).double() / 1e6
    return {"mean_ms": d.mean(0).tolist(), "max_ms": d.max(0).values.tolist()}


def main() -> None:
    import torch

    from repro_torch.comm.codec import get_codec
    from repro_torch.kernels import quant, topk

    lib = build(os.path.join(ROOT, "build", "codec_phases"))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.topk_launch.argtypes = topk._LAUNCH
    lib.quant_launch.argtypes = quant._LAUNCH
    lib.topk_max_active_clusters.argtypes = [I, I, LL, P]
    lib.topk_set_stamps.argtypes = [P]
    lib.quant_set_stamps.argtypes = [P]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def resident(plan):
        out = ctypes.c_int(0)
        assert lib.topk_max_active_clusters(
            plan.cluster, int(plan.survivors == "device"), plan.shared_bytes,
            ctypes.byref(out)) == 0
        return out.value

    def timed(fn):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        err = fn()
        b.record()
        torch.cuda.synchronize()
        assert err == 0, err
        return a.elapsed_time(b)

    for K, L in SHAPES:
        g = torch.Generator(device=dev).manual_seed(K)
        x = torch.randn((K, L), generator=g, device=dev) * 1e-3
        k = get_codec("topk(r=0.01)")._k(L)
        # survivors="device" keeps the cluster forms (the plan of PRs 16-27
        # at these rows), whatever form the plan takes there now
        plan = topk.topk_plan(K, L, k, max_active_clusters=resident,
                              survivors="device")
        vals = torch.empty((K, k), device=dev)
        idx = torch.empty((K, k), dtype=torch.int32, device=dev)
        thr = torch.empty((K,), device=dev)
        scratch = torch.empty((K * plan.cluster, plan.scratch_words),
                              dtype=torch.int64, device=dev)
        st = torch.zeros((K * plan.cluster, 16), dtype=torch.int64,
                         device=dev)
        runs = []
        for rep in range(REPS + 1):
            lib.topk_set_stamps(st.data_ptr() if rep else None)
            ms = timed(lambda: lib.topk_launch(
                x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                thr.data_ptr(), K, L, k, plan.cluster, plan.slab,
                plan.shared_bytes, scratch.data_ptr(),
                int(plan.patterns == "device"), stream))
            if rep:
                runs.append(dict(event_ms=ms, **phase_times(torch, st, 10)))
        want = topk.topk_select_ref(x, k) if K == 1 else None
        equal = (None if want is None else all(
            torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                        else a, b.view(torch.int32)
                        if b.dtype == torch.float32 else b)
            for a, b in zip((vals[0], idx[0], thr[0]),
                            (want[0][0], want[1][0], want[2][0]))))
        print(json.dumps(dict(kernel="topk_select", shape=[K, L], k=k,
                              card=smi, plan=plan.__dict__,
                              phases=TOPK_PHASES, runs=runs,
                              equal_to_plain=equal)), flush=True)
        del vals, idx, thr, scratch, want
        for bits in (8, 4, 2):
            qp = quant.quant_plan(K, L, bits, cluster=16)
            out = torch.empty((K, -(-L // (8 // bits))), dtype=torch.uint8,
                              device=dev)
            sc = torch.empty((K,), device=dev)
            st = torch.zeros((K * qp.cluster, 16), dtype=torch.int64,
                             device=dev)
            runs = []
            for rep in range(REPS + 1):
                lib.quant_set_stamps(st.data_ptr() if rep else None)
                ms = timed(lambda: lib.quant_launch(
                    x.data_ptr(), out.data_ptr(), sc.data_ptr(), K, L, bits,
                    qp.cluster, qp.span, int(qp.variant == "stream"),
                    stream))
                if rep:
                    runs.append(dict(event_ms=ms,
                                     **phase_times(torch, st, 3)))
            print(json.dumps(dict(kernel=f"quantize_pack_int{bits}",
                                  shape=[K, L], card=smi, plan=qp.__dict__,
                                  phases=QUANT_PHASES, runs=runs)),
                  flush=True)
            del out, sc
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
