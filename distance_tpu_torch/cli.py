"""Command-line interface.

Reproduces the reference's clap surface (reference/src/lib.rs:68-131
and src/main.rs): flags ``-i -s -m -o -t -b -l``, one or two positional
inputs, stdin default, exit codes (errors print Debug-style to stderr and
exit 1; ``-l`` prints licence info and exits 0; broken stdout pipe exits 0
silently).  Adds one engine-specific extension: ``--backend`` to pick the
compute path: ``cuda`` (the default: the counter kernel on the card) or
``torch`` (its plain PyTorch version on the CPU).  The port runs one
alignment (square), two (rectangle) and a stream against one loaded
alignment (``-s``), and the JAX CLI's multi-process flags: ``--shard``
in every mode, ``--merge``, ``--launch`` and the multi-host flags
(``parallel/multihost.py``).
"""

from __future__ import annotations

import argparse
import os
import sys

from distance_tpu_torch.fastaio import DistanceError
from distance_tpu_torch.parallel import multihost

USAGE = """All sequences across all input files must be the same length.

       distance alignment.fasta
       cat alignment.fasta | distance
       distance alignment.fasta -o distances.tsv
       distance -t 8 -m jc69 alignment.fasta -o jc69.tsv
       distance alignment1.fasta alignment2.fasta > distances2.tsv
       distance -i smallAlignment.fasta -s bigAlignment.fasta -o distances3.tsv
       cat bigAlignment.fasta | distance smallAlignment.fasta -s - > distances3.tsv
"""

ABOUT = (
    "Calculate genetic distances within/between fasta-format alignments"
    " of DNA sequences"
)

# Reference options rendered with clap 4.5 conventions (about first,
# `Usage:` heading, two-space indent, `<id>` value hints, [default:] and
# [possible values:] annotations, -h/-V appended) — lib.rs:68-131.  The
# engine's own flags follow in a separate section so the reference
# surface reads exactly as its users know it.
_REF_OPTS = [
    ("-i, --input [<input>...]",
     "One or two input alignment files in fasta format. Loaded into"
     " memory. This flag can be omitted and the files passed as"
     " positional arguments"),
    ("-s, --stream <stream>",
     "One input alignment file in fasta format. Streamed from disk (or"
     ' stdin using "-s -"). Requires exactly one file also be loaded'),
    ("-m, --measure <measure>",
     "Which distance measure to use [default: raw] [possible values: n,"
     " n_high, raw, jc69, k80, tn93]"),
    ("-o, --output <output>",
     "Output file in tab-separated-value format. Omit this option to"
     " print to stdout"),
    ("-t, --threads <threads>",
     "How many threads to spin up for pairwise comparisons. Omitting"
     " this option spins up the number of available CPUs"),
    ("-b, --batchsize <batchsize>",
     "Try setting this >(>) 1 to tune the workload per thread"
     " [default: 1]"),
    ("-l, --licenses", "Print licence information and exit"),
    ("-h, --help", "Print help"),
    ("-V, --version", "Print version"),
]

_EXT_OPTS = [
    ("    --backend <backend>",
     "Compute backend: cuda runs the counter kernel on the GPU, torch its"
     " plain version on the CPU [default: cuda] [possible values: cuda,"
     " torch]"),
    ("    --resume",
     "Resume an interrupted run: requires -o; keeps a <output>.progress"
     " sidecar and continues from the last completed strip, producing a"
     " byte-identical file"),
    ("    --shard <K/N>",
     "Compute the K-th of N balanced work shards (K in 0..N-1)."
     " Load-mode shard outputs concatenate to the unsharded file;"
     " stream-mode shards write a .units sidecar and merge via --merge"),
    ("    --launch <N>",
     "Single-command multi-process run: spawn N local shard workers and"
     " merge their outputs; the final file is byte-identical to an"
     " unsharded run"),
    ("    --num-hosts <N>",
     "Multi-host run over a shared filesystem: total number of hosts;"
     " each host computes its shard into <output>.partK and host 0"
     " merges"),
    ("    --host-id <K>", "This host's index in 0..N-1 (with --num-hosts)"),
    ("    --coordinator <ADDR>",
     "torch.distributed coordinator address (host:port); derives"
     " --num-hosts/--host-id from the runtime rendezvous (torchrun's"
     " WORLD_SIZE/RANK when the flags are absent)"),
    ("    --merge <PART>...",
     "Merge shard part files into -o/--output (or stdout) and exit;"
     " interleaves stream-mode parts via their .units sidecars,"
     " concatenates load-mode parts"),
]


def _usage_rendered() -> str:
    # clap renders the override_usage verbatim: every line after the
    # first is indented 7 spaces (including the blank one) and the
    # string carries a trailing indented newline (lib.rs:72-84)
    ul = USAGE.rstrip("\n").split("\n")
    return "\n".join(
        [ul[0]] + ["       " + l.strip() for l in ul[1:]]
    ) + "\n       "


def format_help() -> str:
    usage = _usage_rendered()
    col = max(len(l) for l, _ in _REF_OPTS + _EXT_OPTS) + 2
    lines = [ABOUT, "", "Usage: " + usage, "", "Options:"]
    lines += [f"  {l:<{col}}{t}" for l, t in _REF_OPTS]
    lines += ["", "Engine extensions (not in the reference CLI):"]
    lines += [f"  {l:<{col}}{t}" for l, t in _EXT_OPTS]
    return "\n".join(lines) + "\n"

LICENCES = """
distance_tpu_torch is a from-scratch GPU implementation of the
capabilities of `distance` (Copyright 2022, Ben Jackson, LGPL-2), built on
PyTorch and CUDA.  It contains no code from that project.

This program makes use of the bitwise coding scheme for nucleotides by
Emmanuel Paradis, as used in ape (Paradis, 2004).  Equation (7) in Tamura
and Nei (1993) is rearranged according to ape's source code."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distance",
        description=ABOUT,
        usage=USAGE,
    )
    # -h/--help renders the clap-4.5-shaped text (format_help above);
    # option help text lives ONLY in _REF_OPTS/_EXT_OPTS — per-argument
    # help= strings here would be dead copies that drift
    p.format_help = format_help
    p.add_argument(
        "-i", "--input", nargs="*", default=None,
    )
    p.add_argument("input_pos_1", nargs="?", default=None, help=argparse.SUPPRESS)
    p.add_argument("input_pos_2", nargs="?", default=None, help=argparse.SUPPRESS)
    p.add_argument(
        "-s", "--stream", default=None,
    )
    p.add_argument(
        "-m", "--measure", default="raw",
        choices=["n", "n_high", "raw", "jc69", "k80", "tn93"],
    )
    p.add_argument(
        "-o", "--output", default=None,
    )
    def usize(s: str) -> int:
        # clap's value_parser!(usize) rejects negatives at parse time
        v = int(s)
        if v < 0:
            raise argparse.ArgumentTypeError(f"invalid value '{s}'")
        return v

    p.add_argument(
        "-t", "--threads", type=usize, default=None,
    )
    p.add_argument(
        "-b", "--batchsize", type=usize, default=1,
    )
    p.add_argument(
        "-l", "--licenses", action="store_true",
    )
    p.add_argument(
        "--backend", default="cuda",
        choices=["cuda", "torch"],
    )
    p.add_argument(
        "--resume", action="store_true",
    )
    p.add_argument(
        "--shard", default=None, metavar="K/N",
    )
    p.add_argument(
        "--launch", type=int, default=None, metavar="N",
    )
    p.add_argument(
        "--num-hosts", type=int, default=None, metavar="N",
    )
    p.add_argument(
        "--host-id", type=int, default=None, metavar="K",
    )
    p.add_argument(
        "--coordinator", default=None, metavar="ADDR",
    )
    p.add_argument(
        "--merge", nargs="+", default=None, metavar="PART",
    )
    p.add_argument(
        "-V", "--version", action="version",
        version="distance-tpu-torch 0.1.0",
    )
    return p


# errno -> Rust std::io::ErrorKind names (sys::decode_error_kind), for
# the Debug rendering of DistanceError::IOError (src/lib.rs:22-24).
_ERRNO_KIND = {
    1: "PermissionDenied",      # EPERM
    2: "NotFound",              # ENOENT
    4: "Interrupted",           # EINTR
    12: "OutOfMemory",          # ENOMEM
    13: "PermissionDenied",     # EACCES
    17: "AlreadyExists",        # EEXIST
    20: "NotADirectory",        # ENOTDIR
    21: "IsADirectory",         # EISDIR
    22: "InvalidInput",         # EINVAL
    28: "StorageFull",          # ENOSPC
    29: "NotSeekable",          # ESPIPE
    30: "ReadOnlyFilesystem",   # EROFS
    32: "BrokenPipe",           # EPIPE
    110: "TimedOut",            # ETIMEDOUT
}


def _io_error_debug(e: OSError) -> str:
    """Rust io::Error's Debug spelling for an OS error: the reference's
    main prints `Error: IOError(Os { code: 2, kind: NotFound, message:
    "No such file or directory" })` for a missing input file."""
    code = e.errno if e.errno is not None else 0
    kind = _ERRNO_KIND.get(code, "Uncategorized")
    try:
        msg = os.strerror(code) if code else (e.strerror or str(e))
    except (ValueError, OverflowError):
        msg = e.strerror or str(e)
    return (
        f'IOError(Os {{ code: {code}, kind: {kind},'
        f' message: "{msg}" }})'
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.licenses:
        # the broken-pipe / IO contracts apply here too: `distance -l |
        # head` must exit 0 silently, ENOSPC must print the Debug line
        try:
            print(LICENCES)
            sys.stdout.flush()
        except BrokenPipeError:
            pass
        except OSError as e:
            print(f"Error: {_io_error_debug(e)}", file=sys.stderr)
            return 1
        return 0
    if args.input is not None and len(args.input) > 2:
        # clap semantics (num_args(0..=2), reference/src/lib.rs:85-98):
        # -i consumes at most two values; further values fall through to
        # the positional slots, so three-plus files trip the positional/
        # flag conflict (lib.rs:182-184) rather than a custom message.
        # Values beyond the two positional slots are a clap usage error
        # (exit 2).
        extras, args.input = args.input[2:], args.input[:2]
        for v in extras:
            if args.input_pos_1 is None:
                args.input_pos_1 = v
            elif args.input_pos_2 is None:
                args.input_pos_2 = v
            else:
                print(
                    f"error: unexpected argument '{v}' found\n\n"
                    f"Usage: {_usage_rendered()}\n\n"
                    "For more information, try '--help'.",
                    file=sys.stderr,
                )
                return 2

    try:
        if args.merge is not None:
            # the merge reads part files only: it needs no card
            _merge(args)
            return 0
        if args.launch is not None:
            return multihost.launch(args)

        from distance_tpu_torch.engine import device_of, run, set_up
        from distance_tpu_torch.utils import timing

        ctx = multihost.resolve_multihost(args)
        try:
            with timing.job():
                device_of(args.backend)  # no CUDA device: fail before input
                run(set_up(args))
        except BrokenPipeError:
            raise  # silent exit 0, never a multihost failure signal
        except BaseException as e:
            # ANY failure (incl. KeyboardInterrupt or an unexpected
            # exception) must publish this host's failure marker, or
            # host 0 waits for it forever
            if ctx is not None:
                multihost.finish_multihost(
                    ctx, ok=False, err=str(e) or type(e).__name__)
            raise
        if ctx is not None:
            multihost.finish_multihost(ctx, ok=True)
    except DistanceError as e:
        # The reference prints the error Debug-style from main and exits 1
        # (src/main.rs:4-16 with DistanceError's empty Display).
        print(f'Error: Message("{e}")', file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0
    except OSError as e:
        # The reference wraps io::Error via #[from] (src/lib.rs:22-24)
        # and main Debug-prints it: Error: IOError(Os { code: 2, kind:
        # NotFound, message: "No such file or directory" }), exit 1.
        print(f"Error: {_io_error_debug(e)}", file=sys.stderr)
        return 1
    return 0


def _merge(args) -> None:
    """``--merge PART...``: the parts into -o (or stdout), kept.  A merge
    that fails leaves no output file."""
    if args.output is None:
        multihost.merge_parts(sys.stdout.buffer, args.merge, cleanup=False)
        sys.stdout.buffer.flush()
        return
    out = open(args.output, "wb")
    try:
        with out:
            multihost.merge_parts(out, args.merge, cleanup=False)
    except BaseException:
        os.remove(args.output)
        raise


if __name__ == "__main__":
    sys.exit(main())
