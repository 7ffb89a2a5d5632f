"""What feeding the joint step from disk costs it, on one CUDA card.

    python3 triad_tpu_torch/tools/data_probe.py

Builds the kernels, writes chip_smoke.py phase 16's data (two TriadPack
shards of 96 clips, 192 JPEG captions) into a temporary directory, and
times phase 8's joint step (perf_train_model_config(), every group
unfrozen, B = 64, seed 1) on one model in turns:

  resident        the same two batches on the card every step;
  fed             both batches from AVLoader / TVLoader through the
                  pinned-memory Prefetchers and the device augmentation
                  (phase 16's path);
  fed AV only     the AV batch fed, the TV batch resident (and the
                  converse, "fed TV only");
  fed 1 worker    as fed, with one loader thread each instead of 4;
  fed host aug    as fed, with the augmentation on the host;
  spinning AV / TV  resident batches while one loader runs flat out in a
                  thread of the same process, its batches dropped: the
                  cost of its host work alone to the thread that launches
                  the step's kernels;
  fed, loaders in processes  as fed, each loader running in a spawned
                  process that sends its batches through a
                  multiprocessing queue to the Prefetcher's thread;
                  "pinned cores": the step's thread on core 0 and the
                  loader processes on cores 2 and up (sched_setaffinity of
                  this program's own threads and processes);
  spinning TV in a process  resident batches while a TV loader runs flat
                  out in a spawned process (no shared GIL; shared cores).

Each line: the median ms of the timed steps (CUDA events; the next()
calls included) and, where fed, the median host ms blocked in next().
"""

import os
import shutil
import statistics
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from triad_tpu_torch import kernels  # noqa: E402
from triad_tpu_torch.config import OptimConfig, perf_train_loss_config  # noqa: E402
from triad_tpu_torch.data.datasets import LocalCaptionDataset  # noqa: E402
from triad_tpu_torch.data.device_aug import device_ingest_av, device_ingest_tv  # noqa: E402
from triad_tpu_torch.data.packed import PackedAVDataset  # noqa: E402
from triad_tpu_torch.data.pipeline import AVLoader, Prefetcher, TVLoader, cycling  # noqa: E402
from triad_tpu_torch.data.tokenizer import WordPieceTokenizer  # noqa: E402
from triad_tpu_torch.train.step import StepFactory  # noqa: E402


def _produce(kind, av_dir, tv_dir, vocab, out, cores=None):
    """A spawned process's loop: the loader of ``kind`` over phase 16's
    data, every batch put on ``out`` (None: dropped), on ``cores`` if
    given."""
    if cores:
        os.sched_setaffinity(0, cores)
    if kind == "av":
        loader = AVLoader(PackedAVDataset(av_dir), cs.TRAIN_B, cs.AUDIO, seed=1,
                          device_augment=True)
    else:
        loader = TVLoader(LocalCaptionDataset(tv_dir, 224), WordPieceTokenizer(vocab),
                          cs.TRAIN_B, max_text_tokens=cs.TRAIN_TXT, seed=1, device_augment=True)
    for batch in cycling(loader.epoch):
        if out is not None:
            out.put(batch)


def main():
    if not torch.cuda.is_available():
        sys.exit("data_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build()
    kernels.library()
    ocfg = cs._unfrozen(OptimConfig(gradient_accumulation_steps=1))
    step = StepFactory(perf_train_loss_config(), ocfg).make_step("joint")
    state = cs._new_state(ocfg, 1)
    root = tempfile.mkdtemp(prefix="triad_probe_")
    try:
        av_dir, tv_dir, captions = cs._write_data(root)
        tok = WordPieceTokenizer.build_from_corpus(captions)
        resident_av = {k: v.cuda() for k, v in cs._av_batch(cs.TRAIN_B, 5).items()}
        resident_tv = {k: v.cuda() for k, v in cs._train_batch(cs.TRAIN_B, 6).items()}

        def loaders(workers=4, device_augment=True):
            av = AVLoader(PackedAVDataset(av_dir), cs.TRAIN_B, cs.AUDIO, seed=1,
                          num_workers=workers, device_augment=device_augment)
            tv = TVLoader(LocalCaptionDataset(tv_dir, 224), tok, cs.TRAIN_B,
                          max_text_tokens=cs.TRAIN_TXT, seed=1, num_workers=workers,
                          device_augment=device_augment)
            return av, tv

        def steps(next_av, next_tv, n, warmup):
            times, blocked = [], []
            for _ in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                av, tv = next_av(), next_tv()
                blocked.append((time.perf_counter() - t0) * 1e3)
                _, m = step(state, av, tv, 0.5, 0.5)
                end.record()
                end.synchronize()
                float(m["loss_av"])
                times.append(start.elapsed_time(end))
            return statistics.median(times[warmup:]), statistics.median(blocked[warmup:])

        def fed(feed=("av", "tv"), workers=4, device_augment=True, n=6):
            av, tv = loaders(workers, device_augment)
            pfs = {"av": Prefetcher(cycling(av.epoch), 2, device_ingest_av),
                   "tv": Prefetcher(cycling(tv.epoch), 2, device_ingest_tv)}
            got = steps(pfs["av"].__next__ if "av" in feed else lambda: resident_av,
                        pfs["tv"].__next__ if "tv" in feed else lambda: resident_tv, n, 2)
            for pf in pfs.values():
                pf.close()
            av.pool.close()
            tv.pool.close()
            return got

        def spinning(kind, n=3):
            av, tv = loaders()
            loader = av if kind == "av" else tv
            stop = threading.Event()

            def spin():
                for _ in cycling(loader.epoch):
                    if stop.is_set():
                        return

            thread = threading.Thread(target=spin, daemon=True)
            thread.start()
            got = steps(lambda: resident_av, lambda: resident_tv, n, 0)[0]
            stop.set()
            thread.join()
            av.pool.close()
            tv.pool.close()
            return got

        def fed_from_processes(n=6, pin=False):
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
            cores = set(range(2, os.cpu_count())) if pin else None
            queues = {k: ctx.Queue(maxsize=2) for k in ("av", "tv")}
            procs = [ctx.Process(target=_produce,
                                 args=(k, av_dir, tv_dir, tok.vocab, q, cores),
                                 daemon=True) for k, q in queues.items()]
            for proc in procs:
                proc.start()
            pfs = [Prefetcher(iter(queues["av"].get, None), 2, device_ingest_av),
                   Prefetcher(iter(queues["tv"].get, None), 2, device_ingest_tv)]
            every = os.sched_getaffinity(0)
            if pin:
                os.sched_setaffinity(0, {0})  # this (the step's) thread only
            got = steps(pfs[0].__next__, pfs[1].__next__, n, 2)
            os.sched_setaffinity(0, every)
            for pf in pfs:
                pf.close()
            for proc in procs:
                proc.terminate()
                proc.join()
            return got

        def spinning_process(n=3):
            import multiprocessing as mp

            proc = mp.get_context("spawn").Process(
                target=_produce, args=("tv", av_dir, tv_dir, tok.vocab, None), daemon=True)
            proc.start()
            time.sleep(10)  # past its imports, into the loop
            got = steps(lambda: resident_av, lambda: resident_tv, n, 0)[0]
            proc.terminate()
            proc.join()
            return got

        def resident(n=5):
            return steps(lambda: resident_av, lambda: resident_tv, n, 1)[0]

        for name, run in (("resident", lambda: resident(6)), ("fed", fed),
                          ("resident", resident), ("fed AV only", lambda: fed(("av",))),
                          ("fed TV only", lambda: fed(("tv",))),
                          ("fed 1 worker", lambda: fed(workers=1)),
                          ("fed host aug", lambda: fed(device_augment=False)),
                          ("spinning AV", lambda: spinning("av")),
                          ("spinning TV", lambda: spinning("tv")),
                          ("spinning TV in a process", spinning_process),
                          ("fed, loaders in processes", fed_from_processes),
                          ("fed, processes, pinned cores", lambda: fed_from_processes(pin=True)),
                          ("resident", resident)):
            print(f"{name:>29}: {run()}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
