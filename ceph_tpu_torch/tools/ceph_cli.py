#!/usr/bin/env python3
"""`ceph`-style control-plane CLI (src/ceph.in analogue, EC subset).

Port of ``tools/ceph_cli.py``.  A profile is validated by instantiating
its codec through the port's registry, so ``plugin=cuda`` is accepted:
on the card, or on the CPU where the profile says ``device=cpu`` (without
CUDA, a ``cuda`` profile without it raises).  The state file is
``$CEPH_TPU_TORCH_CLI_STATE`` (the port's prefix for the reference's
``CEPH_TPU_CLI_STATE``), else ``~/.ceph_tpu_torch_cli.json``; a profile
without ``plugin`` validates with ``jerasure``, as in the reference.

Manages erasure-code profiles and pools in a state file the way the
monitor's paxos store holds them (reference control flow: ceph CLI ->
OSDMonitor 'osd erasure-code-profile set' / 'osd pool create ... erasure'
with profile validation by instantiating the plugin,
src/mon/OSDMonitor.cc:5232-5380).

Commands (``python -m ceph_tpu_torch.tools.ceph_cli ...``):
    osd erasure-code-profile set <name> k=v [k=v ...] [--force]
    osd erasure-code-profile get <name>
    osd erasure-code-profile ls
    osd erasure-code-profile rm <name>
    osd pool create <pool> erasure [<profile>] | replicated [<size>]
    osd pool ls
    status
    compression ls
"""

from __future__ import annotations

import json
import os
import sys

from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.plugins.interface import ErasureCodeError

STATE_ENV = "CEPH_TPU_TORCH_CLI_STATE"
DEFAULT_STATE = os.path.expanduser("~/.ceph_tpu_torch_cli.json")
DEFAULT_PROFILE = {
    "plugin": "jerasure",
    "technique": "reed_sol_van",
    "k": "2",
    "m": "1",
}


def load_state(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"profiles": {"default": dict(DEFAULT_PROFILE)}, "pools": {}}


def save_state(path, state):
    with open(path, "w") as f:
        json.dump(state, f, indent=2, sort_keys=True)


def validate_profile(profile: dict) -> dict:
    """Monitor-style validation: instantiate the codec."""
    check = dict(profile)
    plugin = check.pop("plugin", "jerasure")
    ec = registry_mod.instance().factory(plugin, check)
    return {
        "chunk_count": ec.get_chunk_count(),
        "data_chunk_count": ec.get_data_chunk_count(),
    }


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    state_path = os.environ.get(STATE_ENV, DEFAULT_STATE)
    state = load_state(state_path)

    def out(obj):
        print(json.dumps(obj, indent=2, sort_keys=True))

    try:
        if args[:3] == ["osd", "erasure-code-profile", "set"]:
            name = args[3]
            force = "--force" in args
            kvs = [a for a in args[4:] if a != "--force"]
            if name in state["profiles"] and not force:
                print(
                    f"profile {name} exists, use --force to overwrite",
                    file=sys.stderr,
                )
                return 1
            profile = dict(kv.split("=", 1) for kv in kvs)
            info = validate_profile(profile)
            state["profiles"][name] = profile
            save_state(state_path, state)
            out({"profile": name, **info})
            return 0
        if args[:3] == ["osd", "erasure-code-profile", "get"]:
            out(state["profiles"][args[3]])
            return 0
        if args[:3] == ["osd", "erasure-code-profile", "ls"]:
            out(sorted(state["profiles"]))
            return 0
        if args[:3] == ["osd", "erasure-code-profile", "rm"]:
            name = args[3]
            used = [p for p, meta in state["pools"].items()
                    if meta.get("profile") == name]  # replicated: no profile
            if used:
                print(f"profile {name} is in use by pools {used}",
                      file=sys.stderr)
                return 1
            state["profiles"].pop(name, None)
            save_state(state_path, state)
            return 0
        if args[:3] == ["osd", "pool", "create"]:
            pool = args[3]
            kind = args[4]  # type REQUIRED (omitting it is usage rc 2;
            # the reference CLI also takes it explicitly)
            if kind == "replicated":
                # `ceph osd pool create <pool> replicated [<size>]`
                # (reference OSDMonitor::prepare_new_pool TYPE_REPLICATED)
                size = int(args[5]) if len(args) > 5 else 3
                assert size >= 1, f"bad size {size}"
                info = {"pool_type": "replicated", "size": size,
                        "min_size": max(1, size - size // 2)}
                state["pools"][pool] = dict(info)
                save_state(state_path, state)
                out({"pool": pool, **info})
                return 0
            assert kind == "erasure", f"unknown pool type {kind!r}"
            prof_name = args[5] if len(args) > 5 else "default"
            profile = state["profiles"][prof_name]
            info = validate_profile(profile)
            state["pools"][pool] = {
                "pool_type": "erasure", "profile": prof_name, **info}
            save_state(state_path, state)
            out({"pool": pool, "profile": prof_name, **info})
            return 0
        if args[:3] == ["osd", "pool", "ls"]:
            out(state["pools"])
            return 0
        if args[:1] == ["status"]:
            out(
                {
                    "profiles": len(state["profiles"]),
                    "pools": len(state["pools"]),
                    "health": "HEALTH_OK",
                }
            )
            return 0
        if args[:2] == ["compression", "ls"]:
            from ceph_tpu_torch import compressor

            out(compressor.get_supported())
            return 0
    except ErasureCodeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 22
    except (KeyError, IndexError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 2
    print(__doc__, file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
