"""The domain registry: the port's copy of the JAX package's
``domains/registry.py``. Declarative domain-pair specs, resolved once at
start-up, make ``--domain horse2zebra`` just the default entry.

A ``DomainSpec`` is what the data layer needs to produce the four
trainA/trainB/testA/testB splits of one unpaired pair (the TFDS name or a
local image directory, the resize and crop sizes, the augment policy),
plus the domain KEY that checkpoints record in their ``meta.json`` and an
optional shared-generator GROUP whose members must agree on the crop size.

The built-in table covers the TFDS cycle_gan configs and a synthetic
drill pair; ``--domain_registry <json>`` merges user entries over it. A
bad spec fails at construction with the field named. The port cannot
download, so a TFDS spec ends in ``data/sources.py``'s "not ported yet"
unless ``--data_dir``/``--data_source`` point it at local images.

Key grammar: domain keys are ``[a-z0-9_][a-z0-9_-]*``; the serving
tenant key is ``<domain>/<tier>`` (``tenant_key``).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Tuple

_KEY_RE = re.compile(r"^[a-z0-9_][a-z0-9_\-]*$")

# The default entry wherever a domain key is absent: a checkpoint whose
# meta.json records none reads as this domain.
DEFAULT_DOMAIN = "horse2zebra"

# Separator for the (domain, tier) tenant key. "/" never appears in a
# valid domain key or tier name, so the split is unambiguous.
TENANT_SEP = "/"


class DomainError(ValueError):
    """A domain spec or lookup that cannot be satisfied — raised at
    registry construction/resolution, never mid-epoch."""


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """One declarative domain-pair entry.

    ``source`` picks the data backend (data/sources.py): "tfds" reads
    TFDS ``cycle_gan/<tfds_name>``, "folder" reads
    ``data_dir/{trainA,trainB,testA,testB}``, "synthetic" generates
    deterministic images (drills, tests, egress-free environments).
    """

    key: str
    source: str = "tfds"  # "tfds" | "folder" | "synthetic"
    tfds_name: Optional[str] = None  # default: the key itself
    data_dir: Optional[str] = None  # folder root (or TFDS cache dir)
    resize_size: int = 286
    crop_size: int = 256
    # Per-domain augment policy: directional pairs (maps, facades,
    # day2night) must not mirror; the default matches the reference's
    # always-flip pipeline.
    augment_flip: bool = True
    # Reference quirk reproduced by default (config.DataConfig): cache
    # AFTER augmentation, freezing augments past epoch 1.
    cache_augmented: bool = True
    shuffle_buffer: int = 256
    synthetic_train_size: int = 64
    synthetic_test_size: int = 16
    # Shared-generator group for K>2 domain scenarios: pairs in one
    # group must agree on crop_size (one generator architecture serves
    # the whole group); None = standalone pair.
    group: Optional[str] = None
    description: str = ""

    def __post_init__(self):
        if not _KEY_RE.match(self.key or ""):
            raise DomainError(
                f"domain key {self.key!r} is invalid: keys must match "
                f"{_KEY_RE.pattern} (they name checkpoint sidecars, "
                f"telemetry records, and fleet tenants)")
        if self.source not in ("tfds", "folder", "synthetic"):
            raise DomainError(
                f"domain {self.key!r}: source must be 'tfds', 'folder' "
                f"or 'synthetic', got {self.source!r}")
        if self.source == "folder" and not self.data_dir:
            raise DomainError(
                f"domain {self.key!r}: source='folder' requires "
                f"data_dir (the trainA/trainB/testA/testB root)")
        if self.source == "synthetic" and self.data_dir:
            raise DomainError(
                f"domain {self.key!r}: source='synthetic' takes no "
                f"data_dir — remove it or use source='folder'")
        if self.crop_size <= 0 or self.resize_size <= 0:
            raise DomainError(
                f"domain {self.key!r}: resize_size/crop_size must be "
                f"positive, got {self.resize_size}/{self.crop_size}")
        if self.crop_size > self.resize_size:
            raise DomainError(
                f"domain {self.key!r}: crop_size {self.crop_size} "
                f"exceeds resize_size {self.resize_size} — the random "
                f"crop cannot be larger than the resized image")
        if self.group is not None and not _KEY_RE.match(self.group):
            raise DomainError(
                f"domain {self.key!r}: group {self.group!r} is invalid "
                f"(same grammar as domain keys)")

    @property
    def tfds_dataset(self) -> str:
        return self.tfds_name or self.key


# The built-in table: every TFDS cycle_gan config the reference family
# ships, so a second domain pair is `--domain apple2orange` with zero
# further flags, plus a synthetic drill pair for tests/CPU drills.
BUILTIN_SPECS: Tuple[DomainSpec, ...] = (
    DomainSpec(key="horse2zebra",
               description="the reference pair (main.py:22); the "
                           "default entry and legacy back-tag target"),
    DomainSpec(key="apple2orange"),
    DomainSpec(key="summer2winter_yosemite"),
    DomainSpec(key="monet2photo", group="art2photo"),
    DomainSpec(key="cezanne2photo", group="art2photo"),
    DomainSpec(key="ukiyoe2photo", group="art2photo"),
    DomainSpec(key="vangogh2photo", group="art2photo"),
    DomainSpec(key="maps", augment_flip=False,
               description="directional aerial<->map pair; mirroring "
                           "breaks map text"),
    DomainSpec(key="facades", augment_flip=False),
    DomainSpec(key="iphone2dslr_flower"),
    DomainSpec(key="synthetic_drill", source="synthetic",
               description="deterministic synthetic pair for chaos "
                           "drills and egress-free CI"),
)


class DomainRegistry:
    """Immutable key -> DomainSpec table with group validation."""

    def __init__(self, specs):
        table: Dict[str, DomainSpec] = {}
        for spec in specs:
            if spec.key in table:
                raise DomainError(
                    f"duplicate domain key {spec.key!r} in registry")
            table[spec.key] = spec
        self._table = table
        # Shared-generator groups: one generator architecture serves
        # every member, so resolutions must agree — refuse at registry
        # build, not at the first cross-domain fine-tune.
        self._groups: Dict[str, List[str]] = {}
        for spec in table.values():
            if spec.group is not None:
                self._groups.setdefault(spec.group, []).append(spec.key)
        for group, keys in self._groups.items():
            crops = {table[k].crop_size for k in keys}
            if len(crops) > 1:
                raise DomainError(
                    f"shared-generator group {group!r} mixes crop sizes "
                    f"{sorted(crops)} across {sorted(keys)} — one "
                    f"generator cannot serve mismatched resolutions")

    def keys(self) -> List[str]:
        return sorted(self._table)

    def __contains__(self, key: str) -> bool:
        return key in self._table

    def resolve(self, key: str) -> DomainSpec:
        spec = self._table.get(key)
        if spec is None:
            raise DomainError(
                f"unknown domain {key!r}; registered domains: "
                f"{', '.join(self.keys())} (add new pairs via "
                f"--domain_registry <json>)")
        return spec

    def group_members(self, group: str) -> List[str]:
        members = self._groups.get(group)
        if members is None:
            raise DomainError(
                f"unknown shared-generator group {group!r}; have "
                f"{sorted(self._groups)}")
        return sorted(members)

    def groups(self) -> Dict[str, List[str]]:
        return {g: sorted(ks) for g, ks in self._groups.items()}


def load_registry_file(path: str) -> List[DomainSpec]:
    """Parse a user registry JSON: {"domains": [{...spec fields}]}.
    Unknown fields are refused by name — a typo'd option must not be
    silently dropped (the spec would quietly train with defaults)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "domains" not in doc:
        raise DomainError(
            f"{path}: registry file must be an object with a "
            f"'domains' list")
    entries = doc["domains"]
    if not isinstance(entries, list):
        raise DomainError(f"{path}: 'domains' must be a list of specs")
    field_names = {f.name for f in dataclasses.fields(DomainSpec)}
    specs = []
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise DomainError(f"{path}: domains[{i}] is not an object")
        unknown = sorted(set(entry) - field_names)
        if unknown:
            raise DomainError(
                f"{path}: domains[{i}] has unknown fields {unknown}; "
                f"valid fields: {sorted(field_names)}")
        try:
            specs.append(DomainSpec(**entry))
        except DomainError:
            raise
        except (TypeError, ValueError) as e:
            raise DomainError(f"{path}: domains[{i}]: {e}") from e
    return specs


def default_registry(path: Optional[str] = None) -> DomainRegistry:
    """The built-in table, with `path` entries merged OVER it (a user
    spec may redefine a built-in key — e.g. re-pointing horse2zebra at
    a local mirror)."""
    table = {s.key: s for s in BUILTIN_SPECS}
    if path is not None:
        for spec in load_registry_file(path):
            table[spec.key] = spec
    return DomainRegistry(table.values())


def data_config_for(spec: DomainSpec, base=None):
    """Resolve a spec into the DataConfig the pipeline consumes —
    threading point into config.py/data/sources.py/data/pipeline.py.
    `base` carries non-domain knobs (synthetic drill sizes from a tiny
    test config survive; domain fields are overwritten)."""
    from cyclegan_tpu_torch.config import DataConfig

    base = base if base is not None else DataConfig()
    return dataclasses.replace(
        base,
        domain=spec.key,
        dataset=spec.tfds_dataset,
        data_dir=spec.data_dir,
        source=spec.source,
        resize_size=spec.resize_size,
        crop_size=spec.crop_size,
        augment_flip=spec.augment_flip,
        cache_augmented=spec.cache_augmented,
        synthetic_train_size=(spec.synthetic_train_size
                              if spec.source == "synthetic"
                              else base.synthetic_train_size),
        synthetic_test_size=(spec.synthetic_test_size
                             if spec.source == "synthetic"
                             else base.synthetic_test_size),
    )


def tenant_key(domain: str, tier: str) -> str:
    """THE (domain, tier) contract key: checkpoint sidecars record the
    domain half, the serve engine's tier grammar the tier half, and the
    fleet's tenant table is keyed by the join."""
    if not _KEY_RE.match(domain or ""):
        raise DomainError(f"invalid domain key {domain!r}")
    if not tier or TENANT_SEP in tier:
        raise DomainError(f"invalid tier name {tier!r}")
    return f"{domain}{TENANT_SEP}{tier}"
