"""Human3.6m acquisition helper (counterpart of ``ipoke_tpu/data/human36m.py``;
the reference's data/human36m_preprocess.py): authenticated download of the
subject video tgz archives and their extraction.  The frame and flow
processing is the generic ``data/prepare`` pipeline.

The download needs network access and a registered account's PHPSESSID;
without them it fails loudly.

    python -m ipoke_tpu_torch.data.human36m --mode extract --out <dir>
    python -m ipoke_tpu_torch.data.prepare --mode all --video_dir <dir>/S1/Videos ...
"""
from __future__ import annotations

import argparse
import glob
import os
import tarfile

# training subjects S1..S8; official TEST subjects are S9, S11
# (reference split rule, flow_dataset.py:585-600)
SUBJECTS = ["S1", "S5", "S6", "S7", "S8", "S9", "S11"]
TEST_SUBJECTS = {"S9", "S11"}
BASE_URL = "http://vision.imar.ro/human3.6m/filebrowser.php"


def download_all(out_dir, phpsessid):
    """Requires a registered account's PHPSESSID (as the reference does)."""
    import urllib.request

    os.makedirs(out_dir, exist_ok=True)
    for subject in SUBJECTS:
        url = f"{BASE_URL}?download=1&filepath=Videos&filename=Videos_{subject}.tgz"
        dest = os.path.join(out_dir, f"Videos_{subject}.tgz")
        if os.path.exists(dest):
            continue
        req = urllib.request.Request(url, headers={"Cookie": f"PHPSESSID={phpsessid}"})
        with urllib.request.urlopen(req) as r, open(dest, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    return out_dir


def extract_all(out_dir):
    """Each ``Videos_<subject>.tgz`` under ``out_dir`` into ``out_dir/<subject>``."""
    for tgz in sorted(glob.glob(os.path.join(out_dir, "Videos_*.tgz"))):
        subject = os.path.basename(tgz).split("_")[-1].split(".")[0]
        dest = os.path.join(out_dir, subject)
        os.makedirs(dest, exist_ok=True)
        with tarfile.open(tgz) as tf:
            tf.extractall(dest)
    return out_dir


def is_test_subject(path):
    return any(f"/{s}/" in path or path.endswith(s) for s in TEST_SUBJECTS)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ipoke_tpu_torch.data.human36m")
    ap.add_argument("--mode", default="extract", choices=["download", "extract", "all"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--phpsessid", default=None)
    args = ap.parse_args(argv)
    if args.mode in ("download", "all"):
        assert args.phpsessid, "download requires --phpsessid from a logged-in session"
        download_all(args.out, args.phpsessid)
    if args.mode in ("extract", "all"):
        extract_all(args.out)


if __name__ == "__main__":
    main()
