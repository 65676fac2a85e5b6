"""lrc-equivalent plugin: Locally Repairable composite Code.

Port of ``ceph_tpu/plugins/lrc.py``.  Each layer's inner codec comes from
the port's registry, so a layer profile ``plugin=cuda`` (or
``plugin=jerasure backend=cuda``) runs that layer on the card.

Mirrors the reference lrc plugin (reference: src/erasure-code/lrc/
ErasureCodeLrc.{h,cc}):

* a profile is either a JSON ``layers`` description (each layer = a
  chunks-map string like "DDc_D" plus an inner-plugin profile) with a
  ``mapping`` string, or the (k, m, l) shortcut that *generates* mapping +
  layers (one global layer + (k+m)/l local layers; parse_kml,
  ErasureCodeLrc.cc:293-420);
* each layer instantiates an inner codec through the registry
  (layers_init, :215-253; defaults plugin=jerasure technique=reed_sol_van);
* encode walks layers top-down over each layer's chunk subset (:739-776);
* decode walks layers in reverse, recovering what each layer can and
  feeding recovered chunks upward (:643-…); ``_minimum_to_decode`` prefers
  local repair (fewest reads) and falls back to global layers (:568-737,
  cases 1-3).
"""

from __future__ import annotations

import errno as _errno
import json
from typing import Dict, Iterable, List, Mapping, Set

import numpy as np

from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.plugins.interface import (
    ErasureCode,
    ErasureCodeError,
    ErasureCodeProfile,
)

DEFAULT_KML = -1


class Layer:
    def __init__(self, chunks_map: str, profile: ErasureCodeProfile):
        self.chunks_map = chunks_map
        self.profile = profile
        self.data = [i for i, ch in enumerate(chunks_map) if ch == "D"]
        self.coding = [i for i, ch in enumerate(chunks_map) if ch == "c"]
        self.chunks = self.data + self.coding
        self.chunks_as_set: Set[int] = set(self.chunks)
        self.erasure_code = None  # filled by layers_init


def _parse_layer_profile(text: str) -> ErasureCodeProfile:
    """Layer profile may be a space-separated k=v string or a JSON object."""
    prof: ErasureCodeProfile = {}
    text = text.strip()
    if not text:
        return prof
    if text.startswith("{"):
        for key, val in json.loads(text).items():
            prof[str(key)] = str(val)
        return prof
    for tok in text.split():
        if "=" in tok:
            key, val = tok.split("=", 1)
            prof[key] = val
    return prof


class ErasureCodeLrc(ErasureCode):
    def __init__(self, directory: str = ""):
        super().__init__()
        self.layers: List[Layer] = []
        self.chunk_count_ = 0
        self.data_chunk_count_ = 0
        self.directory = directory
        self.rule_steps = [("chooseleaf", "host", 0)]

    # -- contract ----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.chunk_count_

    def get_data_chunk_count(self) -> int:
        return self.data_chunk_count_

    def get_chunk_size(self, object_size: int) -> int:
        return self.layers[0].erasure_code.get_chunk_size(object_size)

    # -- profile parsing ---------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse_kml(profile)
        if "mapping" not in profile:
            raise ErasureCodeError(
                _errno.EINVAL, "the 'mapping' profile is missing"
            )
        mapping = profile["mapping"]
        self.to_mapping(profile)
        self.data_chunk_count_ = mapping.count("D")
        self.chunk_count_ = len(mapping)

        if "layers" not in profile:
            raise ErasureCodeError(
                _errno.EINVAL, "the 'layers' profile is missing"
            )
        self.layers_parse(profile["layers"])
        self.layers_sanity_checks(mapping)
        self.layers_init()
        ErasureCode.init(self, profile)

    def parse_kml(self, profile: ErasureCodeProfile) -> None:
        """(k, m, l) shortcut -> generated mapping + layers (parse_kml)."""
        k = int(profile.get("k", DEFAULT_KML) or DEFAULT_KML)
        m = int(profile.get("m", DEFAULT_KML) or DEFAULT_KML)
        l = int(profile.get("l", DEFAULT_KML) or DEFAULT_KML)
        if k == DEFAULT_KML and m == DEFAULT_KML and l == DEFAULT_KML:
            return
        if DEFAULT_KML in (k, m, l):
            raise ErasureCodeError(
                _errno.EINVAL, "all of k, m, l must be set or none of them"
            )
        for generated in ("mapping", "layers", "crush-steps"):
            if generated in profile:
                raise ErasureCodeError(
                    _errno.EINVAL,
                    f"the {generated} parameter cannot be set when k, m, l are set",
                )
        if (k + m) % l:
            raise ErasureCodeError(_errno.EINVAL, "k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups:
            raise ErasureCodeError(_errno.EINVAL, "k must be a multiple of (k+m)/l")
        if m % groups:
            raise ErasureCodeError(_errno.EINVAL, "m must be a multiple of (k+m)/l")

        mapping = ""
        for _ in range(groups):
            mapping += "D" * (k // groups) + "_" * (m // groups) + "_"
        profile["mapping"] = mapping

        layers = "[ "
        layers += ' [ "'
        for _ in range(groups):
            layers += "D" * (k // groups) + "c" * (m // groups) + "_"
        layers += '", "" ],'
        for i in range(groups):
            layers += ' [ "'
            for j in range(groups):
                layers += ("D" * l + "c") if i == j else "_" * (l + 1)
            layers += '", "" ],'
        profile["layers"] = layers + "]"

        locality = profile.get("crush-locality", "")
        failure_domain = profile.get("crush-failure-domain", "host")
        if locality:
            self.rule_steps = [
                ("choose", locality, groups),
                ("chooseleaf", failure_domain, l + 1),
            ]
        elif failure_domain:
            self.rule_steps = [("chooseleaf", failure_domain, 0)]

    def layers_parse(self, description: str) -> None:
        import re

        # json_spirit tolerates trailing commas (and parse_kml emits one)
        description = re.sub(r",\s*([\]}])", r" \1", description)
        try:
            desc = json.loads(description)
        except json.JSONDecodeError as e:
            raise ErasureCodeError(
                _errno.EINVAL, f"layers parse failure: {e}"
            )
        if not isinstance(desc, list):
            raise ErasureCodeError(
                _errno.EINVAL, "layers must be a JSON array"
            )
        for item in desc:
            if not isinstance(item, list) or not item:
                raise ErasureCodeError(
                    _errno.EINVAL, f"each layer must be a JSON array: {item!r}"
                )
            chunks_map = item[0]
            if not isinstance(chunks_map, str):
                raise ErasureCodeError(
                    _errno.EINVAL, "layer chunks map must be a string"
                )
            prof: ErasureCodeProfile = {}
            if len(item) > 1:
                if isinstance(item[1], str):
                    prof = _parse_layer_profile(item[1])
                elif isinstance(item[1], dict):
                    prof = {str(a): str(b) for a, b in item[1].items()}
            self.layers.append(Layer(chunks_map, prof))

    def layers_sanity_checks(self, mapping: str) -> None:
        if not self.layers:
            raise ErasureCodeError(
                _errno.EINVAL, "at least one layer is required"
            )
        for layer in self.layers:
            if len(layer.chunks_map) != len(mapping):
                raise ErasureCodeError(
                    _errno.EINVAL,
                    f"the size of layer {layer.chunks_map} does not match "
                    f"the mapping {mapping}",
                )

    def layers_init(self) -> None:
        registry = registry_mod.instance()
        for layer in self.layers:
            prof = layer.profile
            prof.setdefault("k", str(len(layer.data)))
            prof.setdefault("m", str(len(layer.coding)))
            prof.setdefault("plugin", "jerasure")
            prof.setdefault("technique", "reed_sol_van")
            plugin = prof["plugin"]
            inner = dict(prof)
            inner.pop("plugin", None)
            layer.erasure_code = registry.factory(
                plugin, inner, self.directory
            )

    # -- encode ------------------------------------------------------------

    def encode_chunks(
        self, want_to_encode: Iterable[int], encoded: Dict[int, np.ndarray]
    ) -> None:
        want = set(want_to_encode)
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if want <= layer.chunks_as_set:
                break
        for layer in self.layers[top:]:
            layer_encoded = {
                j: encoded[c] for j, c in enumerate(layer.chunks)
            }
            layer_want = {
                j for j, c in enumerate(layer.chunks) if c in want
            }
            layer.erasure_code.encode_chunks(layer_want, layer_encoded)

    # -- minimum_to_decode (cases 1-3) --------------------------------------

    def _minimum_to_decode(
        self, want_to_read: Iterable[int], available_chunks: Iterable[int]
    ) -> List[int]:
        want = set(want_to_read)
        avail = set(available_chunks)
        km = self.get_chunk_count()
        erasures_total = {i for i in range(km) if i not in avail}
        erasures_not_recovered = set(erasures_total)
        erasures_want = erasures_total & want

        if not erasures_want:
            return sorted(want)

        minimum: Set[int] = set()
        for layer in reversed(self.layers):
            layer_want = want & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures = layer_want & erasures_want
            if not layer_erasures:
                layer_minimum = layer_want
            else:
                erasures = layer.chunks_as_set & erasures_not_recovered
                if len(erasures) > layer.erasure_code.get_coding_chunk_count():
                    continue
                layer_minimum = layer.chunks_as_set - erasures_not_recovered
                erasures_not_recovered -= erasures
                erasures_want -= erasures
            minimum |= layer_minimum
        if not erasures_want:
            minimum |= want
            minimum -= erasures_total
            return sorted(minimum)

        # case 3: recover helper chunks from any layer
        erasures_total = {i for i in range(km) if i not in avail}
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures_total
            if not layer_erasures:
                continue
            if len(layer_erasures) <= layer.erasure_code.get_coding_chunk_count():
                erasures_total -= layer_erasures
        if not erasures_total:
            return sorted(avail)
        raise ErasureCodeError(
            _errno.EIO, f"not enough chunks in {sorted(avail)} to read {sorted(want)}"
        )

    # -- decode ------------------------------------------------------------

    def decode_chunks(
        self,
        want_to_read: Iterable[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        km = self.get_chunk_count()
        want = set(want_to_read)
        erasures = {i for i in range(km) if i not in chunks}
        want_erasures = erasures & want
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures
            if (
                not layer_erasures
                or len(layer_erasures)
                > layer.erasure_code.get_coding_chunk_count()
            ):
                continue
            layer_chunks = {
                j: decoded[c]
                for j, c in enumerate(layer.chunks)
                if c not in erasures
            }
            layer_decoded = {
                j: decoded[c] for j, c in enumerate(layer.chunks)
            }
            layer_want = {
                j for j, c in enumerate(layer.chunks) if c in want
            }
            layer.erasure_code.decode_chunks(
                layer_want, layer_chunks, layer_decoded
            )
            for j, c in enumerate(layer.chunks):
                decoded[c][:] = layer_decoded[j]
                erasures.discard(c)
            want_erasures = erasures & want
            if not want_erasures:
                break
        if want_erasures:
            raise ErasureCodeError(
                _errno.EIO, f"unable to read {sorted(want_erasures)}"
            )

    def create_rule(self, name: str, crush) -> int:
        return crush.add_rule(name, self.rule_steps, self.rule_root)


class ErasureCodePluginLrc(registry_mod.ErasureCodePlugin):
    def factory(self, directory: str, profile: ErasureCodeProfile):
        ec = ErasureCodeLrc(directory)
        ec.init(profile)
        return ec


def __erasure_code_version__() -> str:
    from ceph_tpu_torch import __version__

    return __version__


def __erasure_code_init__(name: str, directory: str) -> int:
    registry_mod.instance().add(name, ErasureCodePluginLrc())
    return 0
