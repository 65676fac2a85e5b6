#!/usr/bin/env python
"""Plugin existence / introspection CLI (ceph_erasure_code equivalent).

Port of ``tools/ec_info.py`` over the port's registry (reference:
src/test/erasure-code/ceph_erasure_code.cc:50-67) -- instantiates a plugin
from --plugin_exists / --parameter flags and reports success, used by
scripts to gate tests on plugin availability.

    python -m ceph_tpu_torch.tools.ec_info --plugin_exists jerasure
    python -m ceph_tpu_torch.tools.ec_info --plugin lrc \\
        --parameter k=4 --parameter m=2 --parameter l=3
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.plugins import registry as registry_mod


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="erasure code plugin introspection")
    p.add_argument("--plugin_exists", help="check whether the plugin loads")
    p.add_argument("--plugin", help="instantiate and describe a codec")
    p.add_argument("--parameter", action="append", default=[])
    p.add_argument("--erasure-code-dir", default="")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    registry = registry_mod.instance()
    if args.plugin_exists:
        try:
            # a plugin this process loaded already exists (a second load
            # of it would fail its registration with EEXIST)
            if registry.get(args.plugin_exists) is None:
                registry.load(args.plugin_exists, args.erasure_code_dir)
            return 0
        except Exception as e:
            print(e, file=sys.stderr)
            return 1
    if args.plugin:
        profile = {}
        for param in args.parameter:
            if "=" in param:
                key, val = param.split("=", 1)
                profile[key] = val
        ec = registry.factory(args.plugin, profile, args.erasure_code_dir)
        print(
            json.dumps(
                {
                    "plugin": args.plugin,
                    "profile": ec.get_profile(),
                    "chunk_count": ec.get_chunk_count(),
                    "data_chunk_count": ec.get_data_chunk_count(),
                    "coding_chunk_count": ec.get_coding_chunk_count(),
                    "sub_chunk_count": ec.get_sub_chunk_count(),
                    "chunk_size_4096": ec.get_chunk_size(4096),
                    "chunk_mapping": ec.get_chunk_mapping(),
                }
            )
        )
        return 0
    p.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
