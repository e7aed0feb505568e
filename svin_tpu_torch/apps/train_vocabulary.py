"""Train a place-recognition vocabulary from a dataset.

Detect and describe a strided subset of frames, run Hamming k-medoids on
the pooled descriptors (the nearest-codeword kernel on the card), compute
TF_IDF word weights with each frame as one document, and save the
vocabulary in the format both packages load.

Usage:
  python -m svin_tpu_torch.apps.train_vocabulary <euroc_folder> <out.npz> \\
      [--size 1024] [--stride 10] [--max-frames 200] [--iters 8] [--product] \\
      [--device cuda|cpu]

``--product`` trains the two-level product vocabulary instead (two 256-word
codebooks over the descriptor's 128-bit halves, 65,536 joint words, with
joint idf); ``LoopCloser`` detects the format. Runs on ``cuda`` unless
given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset", help="EuRoC-layout folder (mav0/...)")
    ap.add_argument("out", help="output vocabulary path (.npz)")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--stride", type=int, default=10)
    ap.add_argument("--max-frames", type=int, default=200)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--max-keypoints", type=int, default=400)
    ap.add_argument("--product", action="store_true",
                    help="train the 65k-effective-word product vocabulary")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_vocabulary: no CUDA device; pass --device cpu to run on the host")

    from ..loopclosure import retrieval
    from ..ops import descriptor as desc_ops, detection
    from ..pipeline.dataset import read_euroc_folder

    root = args.dataset
    if os.path.isdir(os.path.join(root, "mav0")):
        root = os.path.join(root, "mav0")
    num_cams = max(1, len(glob.glob(os.path.join(root, "cam*"))))

    docs, pooled = [], []
    n_imgs = 0
    for ev in read_euroc_folder(args.dataset, num_cams=num_cams):
        if ev.kind != "frame" or not ev.images:
            continue
        n_imgs += 1
        if (n_imgs - 1) % args.stride:
            continue
        if len(docs) >= args.max_frames:
            break
        img = np.asarray(ev.images[0], np.float32)
        if img.max() > 1.5:  # uint8-range input
            img = img / 255.0
        img = torch.as_tensor(img, device=dev)
        kp = detection.detect(img, max_keypoints=args.max_keypoints)
        d = desc_ops.describe(img, kp.uv, kp.angle, kp.valid)
        docs.append((d, kp.valid))
        pooled.append(d.cpu().numpy()[kp.valid.cpu().numpy()])
    if not pooled:
        print("no images found")
        return 2

    train = torch.as_tensor(np.concatenate(pooled), device=dev)
    print(f"training on {train.shape[0]} descriptors from {len(docs)} frames")
    if args.product:
        pv = retrieval.train_product_vocabulary(train, iters=args.iters)
        pv = pv._replace(idf=retrieval.compute_idf_product(docs, pv))
        retrieval.save_product_vocabulary(args.out, pv)
        print(f"saved product (65k-effective-word) vocabulary to {args.out}")
        return 0
    vocab = retrieval.train_vocabulary(train, size=args.size, iters=args.iters)
    idf = retrieval.compute_idf(docs, vocab)
    retrieval.save_vocabulary(args.out, vocab, weights=idf)
    print(f"saved {args.size}-word vocabulary + idf weights to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
