"""Command-line interface of the port (x3_tpu.cli).

    python -m x3_tpu_torch --input FILE --output FILE [--device cuda|cpu]

converts between the .wav and .x3a types by their extensions; input and
output must differ in type.  Also: --engine, --resync, --quiet, --range
START[:COUNT] (random access), --info (header-index metadata) and --verify
(a full check, no output).  Every conversion runs on --device: "cuda"
(the default) runs the CUDA kernels, "cpu" their plain PyTorch versions.
Multichannel .x3m manifests are not ported yet."""

from __future__ import annotations

import argparse
import sys

from .params import Parameters

NO_X3M = "multichannel .x3m files are not ported to x3_tpu_torch yet"


def get_filetype(filename: str) -> str:
    if filename.endswith(".x3a"):
        return "x3a"
    if filename.endswith(".x3m"):
        return "x3m"
    if filename.endswith(".wav"):
        return "wav"
    raise SystemExit(
        f"Invalid audio file, expecting a '.wav', '.x3a' or '.x3m' file: {filename}"
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="x3",
        description="x3 - efficient lossless compression for low entropy audio wav files.",
    )
    parser.add_argument("-i", "--input", metavar="FILE", required=True, help="The input file, a .wav or .x3a file")
    parser.add_argument(
        "-o", "--output", metavar="FILE", default=None,
        help="The output file, a .wav or .x3a file (not used with --info/--verify)",
    )
    parser.add_argument(
        "--info", action="store_true",
        help="print .x3a archive metadata and frame statistics from the header index (no decode) and exit",
    )
    parser.add_argument(
        "--verify", action="store_true",
        help="check an .x3a archive without writing output: walk every frame (resync past damage), "
        "check every payload CRC, decode every frame; exit 1 if anything is wrong",
    )
    parser.add_argument("--engine", choices=["auto", "torch"], default="auto",
                        help="compute engine (default: auto, which is torch)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the CUDA kernels, default) or cpu (their plain versions)")
    parser.add_argument("--resync", action="store_true", help="skip corrupt frames instead of stopping at the first")
    parser.add_argument("-q", "--quiet", action="store_true", help="suppress statistics output")
    parser.add_argument("--block-len", type=int, default=None, help="encode block length (default 20)")
    parser.add_argument(
        "--range", metavar="START[:COUNT]", default=None, dest="sample_range",
        help="decode only this sample range of an .x3a input to the output WAV (random access by the "
        "frame index; COUNT defaults to the rest of the archive)",
    )
    args = parser.parse_args(argv)

    in_type = get_filetype(args.input)
    if args.info or args.verify:
        from .errors import X3Error

        if in_type == "x3m":
            raise SystemExit(NO_X3M)
        if in_type != "x3a":
            raise SystemExit("--info/--verify take an .x3a or .x3m input.")
        try:
            if args.info:
                from .files import x3a_info

                for k, v in x3a_info(args.input, device=args.device).items():
                    print(f"{k}: {v}")
            if args.verify:
                from .files import verify_x3a

                report = verify_x3a(args.input, engine=args.engine, verbose=not args.quiet, device=args.device)
                n_frames = report["n_frames"]
                print(
                    f"{'ok' if report['ok'] else 'FAILED'}: "
                    f"{n_frames - report['frame_errors']}/{n_frames} frames ok, "
                    f"{report['n_samples_ok']} samples, "
                    f"{report['frame_errors']} frame errors, "
                    f"{report['skipped_bytes']} bytes skipped (engine={report['engine']})"
                )
                if not report["ok"]:
                    if report.get("reason"):
                        print(f"reason: {report['reason']}")
                    return 1
        except (X3Error, OSError, ValueError) as e:
            # An input damaged past inspection exits with a message, not a
            # traceback: these options exist to inspect damaged files.
            raise SystemExit(f"error: {e}")
        return 0

    if args.output is None:
        raise SystemExit("the following arguments are required: -o/--output")
    out_type = get_filetype(args.output)
    if in_type == out_type:
        raise SystemExit("Input must be different file type than output.")
    if "x3m" in (in_type, out_type):
        raise SystemExit(NO_X3M)

    if args.sample_range is not None:
        if not (in_type == "x3a" and out_type == "wav"):
            raise SystemExit("--range requires an .x3a input and a .wav output.")
        from .files import X3aReader
        from .utils.wav import write_wav

        start_s, _, count_s = args.sample_range.partition(":")
        try:
            start = int(start_s or 0)
            count = int(count_s) if count_s else None
        except ValueError:
            raise SystemExit(f"Invalid --range {args.sample_range!r}, want START[:COUNT].")
        with X3aReader(args.input, engine=args.engine, device=args.device) as reader:
            if count is None:
                count = max(reader.n_samples - start, 0)
            write_wav(args.output, reader.read_samples(start, count), reader.spec.sample_rate)
        return 0

    from .files import wav_to_x3a, x3a_to_wav

    params = Parameters(block_len=args.block_len) if args.block_len else Parameters()
    if in_type == "wav":
        wav_to_x3a(args.input, args.output, params=params, engine=args.engine, verbose=not args.quiet,
                   device=args.device)
    else:
        x3a_to_wav(args.input, args.output, engine=args.engine, verbose=not args.quiet, resync=args.resync,
                   device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
