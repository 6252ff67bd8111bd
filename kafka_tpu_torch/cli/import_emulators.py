"""Convert gp_emulator pickle artifacts into .npz banks (port of
``kafka_tpu/cli/import_emulators.py``, on the port's ``obsops.gp_import``).

Users of the original KaFKA carry directories of per-geometry emulator
pickles (``prosail_..._{vza}_{sza}_{raa}.pkl`` — dicts of per-band
``gp_emulator.GaussianProcess`` objects).  This tool converts them once
into plain ``.npz`` banks (stacked ``GPParams``, no foreign classes,
instant loads, readable by either package); ``run_s2 --emulators
<folder>`` then runs the S2 assimilation through those emulators.  The
conversion runs on the CPU.

Usage:
    python -m kafka_tpu_torch.cli.import_emulators /path/pickles /path/out
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

from . import make_console

LOG = logging.getLogger(__name__)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="directory of gp_emulator pickles")
    ap.add_argument("dst", help="output directory for .npz banks")
    ap.add_argument("--pattern", default="*.pkl")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING
    )
    from ..obsops.gp_import import (
        geometry_from_filename,
        load_emulator_bank_file,
        save_bank_npz,
    )

    os.makedirs(args.dst, exist_ok=True)
    n_done = 0
    for path in sorted(
        glob.glob(os.path.join(args.src, args.pattern))
    ):
        try:
            sza, vza, raa = geometry_from_filename(path)
        except ValueError:
            LOG.warning("skipping %s: no _vza_sza_raa geometry in name",
                        path)
            continue
        bank = load_emulator_bank_file(path, device="cpu")
        base = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.dst, f"{base}.npz")
        save_bank_npz(out, bank)
        LOG.info("%s -> %s (sza=%g vza=%g raa=%g)", path, out, sza, vza,
                 raa)
        n_done += 1
    if n_done == 0:
        raise SystemExit(
            f"no emulator pickles matching {args.pattern} in {args.src}"
        )
    print(f"converted {n_done} emulator bank(s) into {args.dst}")
    return 0


console = make_console(main)

if __name__ == "__main__":
    raise SystemExit(main())
