"""Command-line interface of the port (x3_tpu.cli).

    python -m x3_tpu_torch --input FILE --output FILE [--device cuda|cpu]

converts between the .wav, .x3a and .x3m (multi-channel manifest) types by
their extensions; input and output must differ in type.  Also: --engine,
--resync, --quiet, --range START[:COUNT] (random access), --info
(header-index metadata) and --verify (a full check, no output), of an
.x3a or an .x3m.  Every conversion runs on --device: "cuda" (the default)
runs the CUDA kernels, "cpu" their plain PyTorch versions."""

from __future__ import annotations

import argparse
import sys

from .params import Parameters


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

        if in_type not in ("x3a", "x3m"):
            raise SystemExit("--info/--verify take an .x3a or .x3m input.")
        try:
            if args.info:
                if in_type == "x3a":
                    from .files import x3a_info

                    info = x3a_info(args.input, device=args.device)
                else:
                    from .multichannel import x3m_info

                    info = x3m_info(args.input, device=args.device)
                    info.pop("per_channel")
                for k, v in info.items():
                    print(f"{k}: {v}")
            if args.verify:
                if in_type == "x3a":
                    from .files import verify_x3a

                    report = verify_x3a(args.input, engine=args.engine, verbose=not args.quiet,
                                        device=args.device)
                    n_frames = report["n_frames"]
                    detail = (
                        f"{n_frames - report['frame_errors']}/{n_frames} frames ok, "
                        f"{report['n_samples_ok']} samples"
                    )
                else:
                    from .multichannel import verify_x3m

                    report = verify_x3m(args.input, engine=args.engine, verbose=not args.quiet,
                                        device=args.device)
                    detail = f"{report['channels']} channels"
                print(
                    f"{'ok' if report['ok'] else 'FAILED'}: {detail}, "
                    f"{report['frame_errors']} frame errors, "
                    f"{report['skipped_bytes']} bytes skipped (engine={report['engine']})"
                )
                if not report["ok"]:
                    if report.get("reason"):
                        print(f"reason: {report['reason']}")
                    return 1
        except (X3Error, OSError, ValueError) as e:
            # An input damaged past inspection (an unreadable archive or
            # manifest, a missing channel file) exits with a message, not a
            # traceback: these options exist to inspect damaged files.
            raise SystemExit(f"error: {e}")
        return 0

    if args.output is None:
        raise SystemExit("the following arguments are required: -o/--output")
    out_type = get_filetype(args.output)
    if in_type == out_type:
        raise SystemExit("Input must be different file type than output.")

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

    params = Parameters(block_len=args.block_len) if args.block_len else Parameters()
    if in_type == "wav" and out_type == "x3a":
        from .files import wav_to_x3a

        wav_to_x3a(args.input, args.output, params=params, engine=args.engine, verbose=not args.quiet,
                   device=args.device)
    elif in_type == "x3a" and out_type == "wav":
        from .files import x3a_to_wav

        x3a_to_wav(args.input, args.output, engine=args.engine, verbose=not args.quiet, resync=args.resync,
                   device=args.device)
    elif in_type == "wav" and out_type == "x3m":
        from .multichannel import wav_to_x3m

        wav_to_x3m(args.input, args.output, params=params, device=args.device)
    elif in_type == "x3m" and out_type == "wav":
        from .multichannel import x3m_to_wav

        x3m_to_wav(args.input, args.output, engine=args.engine, device=args.device)
    else:
        raise SystemExit(f"Unsupported conversion {in_type} -> {out_type}.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
