"""Dataset preparation (counterpart of ``ipoke_tpu/data/prepare.py``; the
reference's data/prepare_dataset.py, modes extract / prepare /
pose_estimation / all):

  extract : videos -> frame PNGs (cv2 decode and INTER_AREA resize, as the
            JAX package's) + pairwise ``prediction_{i}_{i+lag}.flow.npy``,
            the pairs batched on the card (PWC-lite, ``ops/pwc``; or
            Horn-Schunck, ``ops/flow_ops``, with ``--flow_estimator hs``).
            Where no ``pwc_lite.npz`` is present, PWC-lite is fitted first
            and written there only once it beats Horn-Schunck
            (``fit_pwc_weights``).
  prepare : walk processed dirs -> meta.p pickle (img_path/flow_paths/fid/
            vid/object_id/train arrays), read by ``data/datasets``.
  pose    : keypoints (pose weights present) or downsampled grey frames ->
            nearest neighbours from other videos -> meta_kp_nn.p.

    python -m ipoke_tpu_torch.data.prepare --mode all --video_dir <dir> \\
        --out <processed_dir> --spatial_size 128 --flow_lag 10 [--device cpu]

Frames are read with ``data/image`` (PIL's pixels without PIL); only the
extraction needs cv2, and raises ``ImportError`` where it is missing.  It
runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import pickle
import time

import numpy as np
import torch

from ipoke_tpu_torch import resolve_device
from ipoke_tpu_torch.data.image import read_png, resize, to_grey

log = logging.getLogger(__name__)

NN_CHUNK = 16    # frames per pose-net call of the keypoint branch


def extract_frames(video_path, out_dir, spatial_size):
    """Video -> resized frame PNGs, with cv2 as the JAX package does (its
    PNGs, byte for byte)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    paths = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.resize(frame, (spatial_size, spatial_size), interpolation=cv2.INTER_AREA)
        path = os.path.join(out_dir, f"frame_{i:06d}.png")
        cv2.imwrite(path, frame)
        paths.append(path)
        i += 1
    cap.release()
    return paths


def _frames(paths, device):
    """Frame PNGs as (N, H, W, 3) float32 in [-1, 1] on ``device``."""
    imgs = np.stack([np.asarray(read_png(p), np.float32) / 127.5 - 1.0 for p in paths])
    return torch.from_numpy(imgs).to(device)


def compute_flows(frame_paths, lag, out_dir, batch_size=8, estimator="pwc", device=None):
    """Pairwise optical flow (frame i -> i+lag) in batches on ``device``
    (the card by default), in f32 (``ops/pwc.exact_f32``).

    estimator: 'pwc' (learned PWC-lite, ``ops/pwc``; loads pwc_lite.npz or
    fits itself on synthetic pairs) or 'hs' (weight-free Horn-Schunck)."""
    device = resolve_device(device)
    from ipoke_tpu_torch.ops.pwc import default_params, exact_f32, pwc_flow

    if estimator == "pwc":
        pwc_params = default_params(device)

        def flow_fn(a, b):
            return pwc_flow(pwc_params, a, b)
    else:
        from ipoke_tpu_torch.ops.flow_ops import estimate_flow as flow_fn

    os.makedirs(out_dir, exist_ok=True)
    flow_paths = {}
    pairs = [(i, i + lag) for i in range(len(frame_paths) - lag)]
    for s in range(0, len(pairs), batch_size):
        chunk = pairs[s : s + batch_size]
        f1 = _frames([frame_paths[i] for i, _ in chunk], device)
        f2 = _frames([frame_paths[j] for _, j in chunk], device)
        with torch.no_grad(), exact_f32():
            flows = flow_fn(f1, f2).cpu().numpy()
        for (i, j), fl in zip(chunk, flows):
            # filename encodes (start, end): the per-dataset lag selection
            # parses the frame gap from it
            path = os.path.join(out_dir, f"prediction_{i}_{j}.flow.npy")
            np.save(path, fl.astype(np.float32))
            flow_paths[i] = path
    return flow_paths


FIT_ATTEMPTS = 4         # PWC-lite fits the CLI tries before it gives up
VALIDATION_MARGIN = 0.9  # a kept fit stays under this share of each limit against Horn-Schunck


def fit_pwc_weights(device=None):
    """PWC-lite for the CLI: ``$IPOKE_WEIGHTS/pwc_lite.npz`` where present;
    else the fit of ``ops/pwc.default_params`` (PRNGKey(1234)), checked by
    ``validate_fit`` (each margin of the JAX suite over Horn-Schunck, times
    VALIDATION_MARGIN, on 24 validation pairs per regime), and where it
    misses one, fits from ``fold_in(key, 10000 + attempt)``, up to
    FIT_ATTEMPTS fits.  The first fit that passes is written there; where
    none does, RuntimeError and nothing written.  The recipe is fragile:
    some keys give a net that loses to Horn-Schunck (PERF.md).  The suite's
    absolute ceilings are logged, not required: JAX's own fit from 1234
    misses the 12 px one."""
    from ipoke_tpu_torch.ops import pwc
    from ipoke_tpu_torch.utils import prng

    device = resolve_device(device)
    path = pwc._weights_path()
    if os.path.exists(path):
        return path
    log.info("pwc: %s not found; fitting PWC-lite on synthetic pairs on %s", path, device)
    t0 = time.perf_counter()
    root = prng.prng_key(1234)
    for attempt in range(FIT_ATTEMPTS):
        params = pwc.train_synthetic(root if attempt == 0 else prng.fold_in(root, 10_000 + attempt),
                                     device=device)
        rows = pwc.validate_fit(params, device)
        log.info("pwc: fit %d, validation (value < limit): %s", attempt,
                 "; ".join(f"{check} {v:.3f} < {(VALIDATION_MARGIN if rel else 1) * lim:.3f}"
                           f"{'' if rel else ' (not required)'}" for check, v, lim, rel in rows))
        if all(v < VALIDATION_MARGIN * lim for _, v, lim, rel in rows if rel):
            break
    else:
        raise RuntimeError(f"none of {FIT_ATTEMPTS} PWC-lite fits beats Horn-Schunck by every margin; "
                           f"mount a pwc_lite.npz at {path} or use --flow_estimator hs")
    pwc.save_params(params, path)
    fit_s = time.perf_counter() - t0
    log.info("pwc: fit %d steps of 8 pairs at 64^2 on %s (%d fits) in %.3f s (%.3f ms per step); "
             "saved %s", 900 * (attempt + 1), device, attempt + 1, fit_s,
             fit_s / (900 * (attempt + 1)) * 1e3, path)
    return path


def _check_flow_naming(vdir, flow_files):
    """Reject trees prepared with the legacy ``prediction_{lag}_{i}`` naming:
    parsing those with the current ``prediction_{start}_{end}`` convention
    would silently read the LAG as the start frame, mis-keying every flow.
    Legacy trees are recognizable because the second-to-last field (the lag)
    is constant across the directory while the last varies; with the
    current naming the start index varies file to file."""
    if len(flow_files) < 2:
        return
    heads, tails = set(), set()
    for p in flow_files:
        parts = os.path.basename(p).split(".")[0].split("_")
        try:
            heads.add(int(parts[-2]))
            tails.add(int(parts[-1]))
        except (ValueError, IndexError):
            raise RuntimeError(
                f"unparseable flow filename {p!r}; expected "
                f"'prediction_{{start}}_{{end}}.flow.npy'")
    if len(heads) == 1 and len(tails) > 1:
        raise RuntimeError(
            f"{vdir} looks like a legacy flow tree "
            f"(prediction_{{lag}}_{{i}} naming: constant second field "
            f"{heads.pop()}): re-run `python -m ipoke_tpu_torch.data.prepare` to "
            f"regenerate flows with the prediction_{{start}}_{{end}} naming")


def build_meta(processed_root, out_path=None, train_fraction=0.9):
    """Walk processed video dirs -> meta pickle with aligned per-frame arrays
    (prepare_dataset.py 'prepare' mode schema): only frames with a flow,
    video ids in sorted order, the first ``int(n * train_fraction)`` videos
    (or a single one) training."""
    meta = {"img_path": [], "flow_paths": [], "fid": [], "vid": [], "object_id": [], "train": []}
    video_dirs = sorted(
        d for d in glob.glob(os.path.join(processed_root, "*")) if os.path.isdir(d)
    )
    for vid_id, vdir in enumerate(video_dirs):
        frames = sorted(glob.glob(os.path.join(vdir, "frame_*.png")))
        flow_files = glob.glob(os.path.join(vdir, "*.flow.npy"))
        _check_flow_naming(vdir, flow_files)
        flows = {
            int(os.path.basename(p).split(".")[0].split("_")[-2]): p
            for p in flow_files
        }
        is_train = vid_id < int(len(video_dirs) * train_fraction) or len(video_dirs) == 1
        for fid, fp in enumerate(frames):
            if fid not in flows:
                continue
            meta["img_path"].append(os.path.relpath(fp, processed_root))
            meta["flow_paths"].append([os.path.relpath(flows[fid], processed_root)])
            meta["fid"].append(fid)
            meta["vid"].append(vid_id)
            meta["object_id"].append(vid_id)
            meta["train"].append(is_train)
    meta = {k: np.asarray(v) for k, v in meta.items()}
    out_path = out_path or os.path.join(processed_root, "meta.p")
    with open(out_path, "wb") as f:
        pickle.dump(meta, f)
    return out_path


def _keypoint_feats(paths, device):
    """Each frame's relative keypoints, flattened: the pose net on
    ``device``, NN_CHUNK frames per call."""
    from ipoke_tpu_torch.metrics.pose import keypoints_rel

    feats = []
    for s in range(0, len(paths), NN_CHUNK):
        kps, _ = keypoints_rel(_frames(paths[s:s + NN_CHUNK], device))
        feats.extend(np.asarray(kps.cpu().numpy()).reshape(len(kps), -1))
    return feats


def keypoint_nn_ids(meta_path, out_path=None, k=1, device=None):
    """Keypoint-space nearest neighbours for the transfer test (reference
    get_nn, flow_dataset.py:628-713).  Keypoints need pose weights (then on
    ``device``, the card by default); without them the neighbours are taken
    in image space, on frames made grey and resized to 16x16 as PIL's
    ``convert("L").resize((16, 16))`` does (bicubic)."""
    from ipoke_tpu_torch.metrics.pose import pose_weights_available

    with open(meta_path, "rb") as f:
        meta = pickle.load(f)
    root = os.path.dirname(os.path.abspath(meta_path))
    n = len(meta["img_path"])
    paths = [os.path.join(root, str(meta["img_path"][i])) for i in range(n)]

    if pose_weights_available():
        feats = _keypoint_feats(paths, resolve_device(device))
    else:
        feats = [np.asarray(resize(to_grey(read_png(p)), (16, 16)), np.float32).reshape(-1) / 255.0
                 for p in paths]
    feats = np.stack(feats)
    vid = np.asarray(meta["vid"])
    nn_ids = np.zeros(n, np.int64)
    for i in range(n):
        d = np.sum((feats - feats[i]) ** 2, axis=1)
        d[vid == vid[i]] = np.inf  # NN must come from a different video
        nn_ids[i] = int(np.argmin(d)) if np.isfinite(d).any() else i
    meta["nn_ids"] = nn_ids
    out_path = out_path or os.path.join(root, "meta_kp_nn.p")
    with open(out_path, "wb") as f:
        pickle.dump(meta, f)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.data.prepare")
    ap.add_argument("--mode", default="all", choices=["extract", "prepare", "pose_estimation", "all"])
    ap.add_argument("--video_dir", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--spatial_size", type=int, default=128)
    ap.add_argument("--flow_lag", type=int, default=10)
    ap.add_argument("--flow_estimator", default="pwc", choices=["pwc", "hs"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:   # no CUDA device and no --device
        raise SystemExit(f"{e}; on the command line: --device cpu") from None

    if args.mode in ("extract", "all"):
        videos = sorted(
            glob.glob(os.path.join(args.video_dir, "*.mp4"))
            + glob.glob(os.path.join(args.video_dir, "*.avi"))
        )
        if videos and args.flow_estimator == "pwc":   # fit before the first video's clock
            try:
                fit_pwc_weights(device)
            except RuntimeError as e:
                raise SystemExit(f"prepare: {e}") from None
        for v in videos:
            name = os.path.splitext(os.path.basename(v))[0]
            vdir = os.path.join(args.out, name)
            t0 = time.perf_counter()
            frames = extract_frames(v, vdir, args.spatial_size)
            t1 = time.perf_counter()
            flows = compute_flows(frames, args.flow_lag, vdir, estimator=args.flow_estimator,
                                  device=device)
            t2 = time.perf_counter()
            log.info("prepare: %s: extract %.3f s; %d flow pairs in %.3f s on %s", name, t1 - t0,
                     len(flows), t2 - t1, device)
            print(f"{name}: {len(frames)} frames")
    if args.mode in ("prepare", "all"):
        t0 = time.perf_counter()
        path = build_meta(args.out)
        log.info("prepare: meta in %.3f s", time.perf_counter() - t0)
        print("meta:", path)
    if args.mode in ("pose_estimation", "all"):
        t0 = time.perf_counter()
        path = keypoint_nn_ids(os.path.join(args.out, "meta.p"), device=device)
        log.info("prepare: nn ids in %.3f s", time.perf_counter() - t0)
        print("nn meta:", path)


if __name__ == "__main__":
    main()
