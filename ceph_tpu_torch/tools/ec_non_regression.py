#!/usr/bin/env python
"""Corpus non-regression tool (ceph_erasure_code_non_regression equivalent).

Port of ``tools/ec_non_regression.py`` over the port's registry, with the
same directory layout, payload rule and erasure checks, so a corpus made by
either package's tool checks with the other's.

--create writes a deterministic payload + every encoded chunk into a
directory keyed by plugin/stripe-width/parameters; --check re-encodes the
archived payload and memcmps chunk-for-chunk, then decodes with 1 and 2
erasures verifying recovered bytes (reference: src/test/erasure-code/
ceph_erasure_code_non_regression.cc:119-139 directory layout, :154-197
create, :226-289 check).  This is the cross-version bit-exactness guarantee:
a corpus created by any version of this framework must check against every
later version.

    python -m ceph_tpu_torch.tools.ec_non_regression --check \
        --base tests/data/ec_corpus --plugin jerasure --stripe-width 4096 \
        --parameter k=4 --parameter m=2 --parameter technique=reed_sol_van
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

from ceph_tpu_torch.plugins import registry as registry_mod


def parse_args(argv):
    p = argparse.ArgumentParser(description="erasure code non-regression")
    p.add_argument("--stripe-width", type=int, default=4 * 1024,
                   help="stripe width in bytes")
    p.add_argument("--plugin", default="jerasure")
    p.add_argument("--base", default=".",
                   help="base directory for the corpus")
    p.add_argument("--parameter", action="append", default=[])
    p.add_argument("--create", action="store_true")
    p.add_argument("--check", action="store_true")
    return p.parse_args(argv)


def directory_argv(name: str) -> list:
    """The arguments that name the corpus directory ``name`` (the layout's
    inverse: ``plugin=<p> stripe-width=<w>`` and each parameter, none of
    which may hold a space)."""
    plugin, width, *params = name.split(" ")
    assert plugin.startswith("plugin=") and \
        width.startswith("stripe-width="), name
    argv = ["--plugin", plugin[len("plugin="):],
            "--stripe-width", width[len("stripe-width="):]]
    for param in params:
        argv += ["--parameter", param]
    return argv


class NonRegression:
    def __init__(self, args):
        self.args = args
        self.profile = {}
        directory = os.path.join(
            args.base,
            f"plugin={args.plugin} stripe-width={args.stripe_width}",
        )
        for param in args.parameter:
            if param.count("=") != 1:
                print(f"--parameter {param} ignored", file=sys.stderr)
                continue
            key, val = param.split("=")
            self.profile[key] = val
            directory += " " + param
        self.directory = directory

    def content_path(self):
        return os.path.join(self.directory, "content")

    def chunk_path(self, i):
        return os.path.join(self.directory, str(i))

    def codec(self):
        return registry_mod.instance().factory(
            self.args.plugin, dict(self.profile)
        )

    def run_create(self) -> int:
        ec = self.codec()
        os.makedirs(self.directory, exist_ok=False)
        payload_chunk = bytes(
            ord("a") + random.randrange(26) for _ in range(37)
        )
        data = (payload_chunk * (self.args.stripe_width // 37 + 1))[
            : self.args.stripe_width
        ]
        with open(self.content_path(), "wb") as f:
            f.write(data)
        want = set(range(ec.get_chunk_count()))
        encoded = ec.encode(want, data)
        for i, chunk in encoded.items():
            with open(self.chunk_path(i), "wb") as f:
                f.write(chunk.tobytes())
        return 0

    def decode_erasures(self, ec, erasures, encoded) -> int:
        available = {
            i: c for i, c in encoded.items() if i not in erasures
        }
        decoded = ec.decode(set(erasures), available)
        for e in erasures:
            if not np.array_equal(decoded[e], encoded[e]):
                print(f"chunk {e} incorrectly recovered", file=sys.stderr)
                return 1
        return 0

    def run_check(self) -> int:
        ec = self.codec()
        with open(self.content_path(), "rb") as f:
            data = f.read()
        want = set(range(ec.get_chunk_count()))
        encoded = ec.encode(want, data)
        for i, chunk in encoded.items():
            with open(self.chunk_path(i), "rb") as f:
                existing = f.read()
            if existing != chunk.tobytes():
                print(f"chunk {i} encodes differently", file=sys.stderr)
                return 1
        # single erasure: specific code path in every plugin
        if self.decode_erasures(ec, {0}, encoded):
            return 1
        if ec.get_chunk_count() - ec.get_data_chunk_count() > 1:
            # two erasures: the general case
            if self.decode_erasures(
                ec, {0, ec.get_chunk_count() - 1}, encoded
            ):
                return 1
        return 0


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if not args.create and not args.check:
        print("must specify either --check, or --create", file=sys.stderr)
        return 1
    nr = NonRegression(args)
    if args.create:
        ret = nr.run_create()
        if ret:
            return ret
    if args.check:
        ret = nr.run_check()
        if ret:
            return ret
    return 0


if __name__ == "__main__":
    sys.exit(main())
