"""dmlctpu-fs — ls/cat/cp/stat over any registered filesystem backend.

The port's counterpart of the JAX package's ``bin/dmlctpu-fs``, over the
port's ``io`` (the same native FileSystem dispatch, TLS included), with
the same commands, output and exit codes:

    python -m dmlc_core_tpu_torch.fs ls  [-r] <uri>
    python -m dmlc_core_tpu_torch.fs cat <uri>
    python -m dmlc_core_tpu_torch.fs cp  <src-uri> <dst-uri>
    python -m dmlc_core_tpu_torch.fs stat <uri>

URIs: bare paths, file://, s3://, azure://, hdfs://, http(s)://.
Credentials/endpoints via the usual env contract (S3_ACCESS_KEY_ID /
AWS_*, AZURE_STORAGE_*, DMLCTPU_TLS_*).
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Optional
from urllib.parse import urlsplit

from .io import listdir, open_stream, path_info


def _same_target_key(uri: str):
    """What a URI names, for refusing a copy onto its own source (opening
    the destination truncates it).  file:// and bare paths alias one
    backend, so both go through realpath.  Remote URIs normalise only what
    provably aliases: scheme and host case, and duplicate slashes on
    hierarchical-path servers (HDFS collapses them; S3/Azure keys treat
    '//' as distinct).  The query stays: it may select another resource
    (``?versionId=OLD`` is a legitimate restore source)."""
    if uri.startswith("file://"):
        uri = uri[len("file://"):]
    if "://" in uri:
        parts = urlsplit(uri)
        path = parts.path
        if parts.scheme.lower() in ("hdfs", "webhdfs"):
            while "//" in path:
                path = path.replace("//", "/")
        return (parts.scheme.lower(), parts.netloc.lower(), path,
                parts.query)
    return os.path.realpath(uri)


class _Counter:
    """A write-through sink that counts the bytes it passes on."""

    def __init__(self, dst):
        self.dst, self.n = dst, 0

    def write(self, chunk):
        self.dst.write(chunk)
        self.n += len(chunk)


def _run(args) -> int:
    if args.cmd == "ls":
        for info in listdir(args.uri, recursive=args.recursive):
            kind = "d" if info.is_dir else "f"
            print(f"{kind} {info.size:>12} {info.path}")
    elif args.cmd == "cat":
        sys.stdout.flush()
        with open_stream(args.uri) as src:
            shutil.copyfileobj(src, sys.stdout.buffer, 1 << 20)
        sys.stdout.buffer.flush()
    elif args.cmd == "cp":
        if _same_target_key(args.src) == _same_target_key(args.dst):
            print(f"dmlctpu-fs: '{args.src}' and '{args.dst}' are the "
                  "same file", file=sys.stderr)
            return 1
        with open_stream(args.src) as src, open_stream(args.dst, "w") as dst:
            counter = _Counter(dst)
            shutil.copyfileobj(src, counter, 1 << 20)
        print(f"copied {counter.n} bytes", file=sys.stderr)
    elif args.cmd == "stat":
        info = path_info(args.uri)
        print(f"{'directory' if info.is_dir else 'file'} "
              f"size={info.size} {info.path}")
    return 0


def main(argv: Optional[list] = None) -> int:
    """Run one command; returns the exit code (0, or 1 with the error on
    stderr)."""
    ap = argparse.ArgumentParser(prog="dmlctpu-fs",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ls = sub.add_parser("ls", help="list a directory")
    ls.add_argument("-r", "--recursive", action="store_true")
    ls.add_argument("uri")
    cat = sub.add_parser("cat", help="stream a file to stdout")
    cat.add_argument("uri")
    cp = sub.add_parser("cp", help="copy between any two backends")
    cp.add_argument("src")
    cp.add_argument("dst")
    st = sub.add_parser("stat", help="show one path's type and size")
    st.add_argument("uri")
    args = ap.parse_args(argv)
    try:
        return _run(args)
    except BrokenPipeError:
        return 0
    except Exception as e:  # noqa: BLE001 — CLI boundary: message, not traceback
        print(f"dmlctpu-fs: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
