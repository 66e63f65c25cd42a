"""Schema API: column metadata + selection algebra, pbtxt/JSON round-trip.

From-scratch, dependency-free analog of the reference's schema layer
(merlin_standard_lib/schema/schema.py:71-550 and the betterproto
binding in proto/schema_bp.py). File-format compatible with the
tensorflow_metadata ``Schema`` proto-text / proto-JSON subset that NVTabular
emits and the reference consumes, so existing ``schema.pbtxt`` / ``schema.json``
artifacts (e.g. rees46_schema.pbtxt) load unchanged.

No protobuf runtime is used: a small hand-rolled proto-text reader/writer covers
the ``feature { ... }`` subset (value_count, fixed_shape, int_domain,
float_domain, annotation.tag/extra_metadata).
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Union

from .tags import Tags, normalize_tag

TagsType = Union[str, Tags]


class FeatureType:
    """Feature value types, mirroring tensorflow_metadata FeatureType enum values."""

    TYPE_UNKNOWN = 0
    BYTES = 1
    INT = 2
    FLOAT = 3

    _TO_NAME = {0: "TYPE_UNKNOWN", 1: "BYTES", 2: "INT", 3: "FLOAT"}
    _FROM_NAME = {v: k for k, v in _TO_NAME.items()}

    @classmethod
    def name(cls, value: int) -> str:
        return cls._TO_NAME.get(value, "TYPE_UNKNOWN")

    @classmethod
    def parse(cls, value) -> int:
        if isinstance(value, int):
            return value
        return cls._FROM_NAME.get(str(value).upper(), 0)


@dataclasses.dataclass
class ValueCount:
    """Ragged-list length bounds (reference: proto/schema_bp.py ValueCount)."""

    min: int = 0
    max: int = 0


@dataclasses.dataclass
class FixedShape:
    dims: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class IntDomain:
    name: str = ""
    min: int = 0
    max: int = 0
    is_categorical: bool = False


@dataclasses.dataclass
class FloatDomain:
    name: str = ""
    min: float = 0.0
    max: float = 0.0


@dataclasses.dataclass
class ColumnSchema:
    """One column's metadata.

    Parity target: reference ColumnSchema (merlin_standard_lib/schema/schema.py:71-207)
    — creation helpers, tag handling, and domain accessors.
    """

    name: str = ""
    type: int = FeatureType.TYPE_UNKNOWN
    tags: List[str] = dataclasses.field(default_factory=list)
    value_count: Optional[ValueCount] = None
    shape: Optional[FixedShape] = None
    int_domain: Optional[IntDomain] = None
    float_domain: Optional[FloatDomain] = None
    extra_metadata: Dict[str, object] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ create
    @classmethod
    def create_categorical(
        cls,
        name: str,
        num_items: int,
        shape: Optional[Sequence[int]] = None,
        value_count: Optional[ValueCount] = None,
        min_index: int = 0,
        tags: Optional[Sequence[TagsType]] = None,
        **kwargs,
    ) -> "ColumnSchema":
        tags = [normalize_tag(t) for t in (tags or [])]
        if Tags.CATEGORICAL.value not in tags:
            tags.append(Tags.CATEGORICAL.value)
        if value_count is not None and Tags.LIST.value not in tags:
            tags.append(Tags.LIST.value)
        return cls(
            name=name,
            type=FeatureType.INT,
            tags=tags,
            value_count=value_count,
            shape=FixedShape(list(shape)) if shape else None,
            int_domain=IntDomain(name=name, min=min_index, max=num_items, is_categorical=True),
            **kwargs,
        )

    @classmethod
    def create_continuous(
        cls,
        name: str,
        is_float: bool = True,
        min_value: Union[int, float] = 0,
        max_value: Union[int, float] = 0,
        shape: Optional[Sequence[int]] = None,
        value_count: Optional[ValueCount] = None,
        tags: Optional[Sequence[TagsType]] = None,
        **kwargs,
    ) -> "ColumnSchema":
        tags = [normalize_tag(t) for t in (tags or [])]
        if Tags.CONTINUOUS.value not in tags:
            tags.append(Tags.CONTINUOUS.value)
        if value_count is not None and Tags.LIST.value not in tags:
            tags.append(Tags.LIST.value)
        if is_float:
            domain_kwargs = dict(
                float_domain=FloatDomain(name=name, min=float(min_value), max=float(max_value))
            )
        else:
            domain_kwargs = dict(
                int_domain=IntDomain(
                    name=name, min=int(min_value), max=int(max_value), is_categorical=False
                )
            )
        return cls(
            name=name,
            type=FeatureType.FLOAT if is_float else FeatureType.INT,
            tags=tags,
            value_count=value_count,
            shape=FixedShape(list(shape)) if shape else None,
            **domain_kwargs,
            **kwargs,
        )

    # -------------------------------------------------------------------- tags
    def with_tags(self, tags: Union[TagsType, Sequence[TagsType]]) -> "ColumnSchema":
        if isinstance(tags, (str, Tags)):
            tags = [tags]
        new_tags = list(self.tags)
        for t in tags:
            t = normalize_tag(t)
            if t not in new_tags:
                new_tags.append(t)
        return dataclasses.replace(self, tags=new_tags)

    def with_name(self, name: str) -> "ColumnSchema":
        out = dataclasses.replace(self, name=name)
        if out.int_domain:
            out.int_domain = dataclasses.replace(out.int_domain, name=name)
        if out.float_domain:
            out.float_domain = dataclasses.replace(out.float_domain, name=name)
        return out

    def has_tag(self, tag: TagsType) -> bool:
        return normalize_tag(tag) in {normalize_tag(t) for t in self.tags}

    # ---------------------------------------------------------------- property
    @property
    def is_list(self) -> bool:
        return self.value_count is not None or self.has_tag(Tags.LIST)

    @property
    def is_categorical(self) -> bool:
        return self.has_tag(Tags.CATEGORICAL) or bool(
            self.int_domain and self.int_domain.is_categorical
        )

    @property
    def is_continuous(self) -> bool:
        return self.has_tag(Tags.CONTINUOUS) or not self.is_categorical

    @property
    def cardinality(self) -> Optional[int]:
        """Number of embedding rows = int_domain.max + 1.

        Matches reference ``categorical_cardinalities`` (schema.py:541-550).
        """
        if self.int_domain is not None and self.is_categorical:
            return int(self.int_domain.max) + 1
        return None

    @property
    def max_sequence_length(self) -> Optional[int]:
        if self.value_count is not None:
            return int(self.value_count.max)
        if self.shape and self.shape.dims:
            return int(self.shape.dims[0])
        return None

    def __hash__(self):
        return hash(self.name)


class Schema:
    """Ordered collection of ColumnSchema with selection algebra.

    Parity target: reference Schema (merlin_standard_lib/schema/schema.py:215-516):
    select/remove by tag & name, +/- set algebra, item-id lookup, cardinalities,
    pbtxt/json round-trip.
    """

    def __init__(self, columns: Optional[Iterable[Union[ColumnSchema, str]]] = None):
        cols: List[ColumnSchema] = []
        for c in columns or []:
            if isinstance(c, str):
                c = ColumnSchema(name=c)
            cols.append(c)
        self.columns: List[ColumnSchema] = cols

    # --------------------------------------------------------------- accessors
    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    @property
    def column_schemas(self) -> Dict[str, ColumnSchema]:
        return {c.name: c for c in self.columns}

    def __getitem__(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def __iter__(self):
        return iter(self.columns)

    def __len__(self):
        return len(self.columns)

    def __eq__(self, other):
        return isinstance(other, Schema) and self.columns == other.columns

    def __repr__(self):
        return f"Schema(columns={self.column_names})"

    # ----------------------------------------------------------------- algebra
    def select_by_tag(self, tags: Union[TagsType, Sequence[TagsType]]) -> "Schema":
        if isinstance(tags, (str, Tags)):
            tags = [tags]
        want = {normalize_tag(t) for t in tags}
        return Schema([c for c in self.columns if want & {normalize_tag(t) for t in c.tags}])

    def remove_by_tag(self, tags: Union[TagsType, Sequence[TagsType]]) -> "Schema":
        if isinstance(tags, (str, Tags)):
            tags = [tags]
        drop = {normalize_tag(t) for t in tags}
        return Schema([c for c in self.columns if not (drop & {normalize_tag(t) for t in c.tags})])

    def select_by_name(self, names: Union[str, Sequence[str]]) -> "Schema":
        if isinstance(names, str):
            names = [names]
        name_set = set(names)
        return Schema([c for c in self.columns if c.name in name_set])

    def remove_by_name(self, names: Union[str, Sequence[str]]) -> "Schema":
        if isinstance(names, str):
            names = [names]
        name_set = set(names)
        return Schema([c for c in self.columns if c.name not in name_set])

    def filter_columns_from_dict(self, input_dict: Dict[str, object]) -> Dict[str, object]:
        names = set(self.column_names)
        return {k: v for k, v in input_dict.items() if k in names}

    def add(self, other: Union["Schema", ColumnSchema], allow_overlap: bool = True) -> "Schema":
        if isinstance(other, ColumnSchema):
            other = Schema([other])
        existing = set(self.column_names)
        overlap = [c for c in other.columns if c.name in existing]
        if overlap and not allow_overlap:
            raise ValueError(f"Overlapping columns: {[c.name for c in overlap]}")
        new = [c for c in other.columns if c.name not in existing]
        return Schema(self.columns + new)

    def __add__(self, other):
        return self.add(other)

    def __sub__(self, other: "Schema") -> "Schema":
        return self.remove_by_name(other.column_names)

    # ------------------------------------------------------------- conveniences
    def categorical_cardinalities(self) -> Dict[str, int]:
        out = {}
        for c in self.columns:
            card = c.cardinality
            if card is not None:
                out[c.name] = card
        return out

    @property
    def item_id_column_name(self) -> str:
        for c in self.columns:
            if c.has_tag(Tags.ITEM_ID):
                return c.name
        raise ValueError("There is no column tagged as item_id in the schema")

    @property
    def item_id_column(self) -> ColumnSchema:
        return self[self.item_id_column_name]

    def sequence_length(self, default: Optional[int] = None) -> Optional[int]:
        """Max list length over list columns."""
        lengths = [c.max_sequence_length for c in self.columns if c.max_sequence_length]
        return max(lengths) if lengths else default

    # ------------------------------------------------------------------ pbtxt
    @classmethod
    def from_proto_text(cls, path_or_text: str) -> "Schema":
        import os

        text = path_or_text
        if "\n" not in path_or_text and (
            os.path.exists(path_or_text)
            or path_or_text.endswith((".pbtxt", ".pb_txt", ".txt"))
        ):
            # a path (any extension) — not inline proto text; a nonexistent
            # path with a schema-ish extension gets a clean file error
            # instead of a baffling tokenizer error
            with open(path_or_text) as f:
                text = f.read()
        return _parse_proto_text(cls, text)

    def to_proto_text(self) -> str:
        return _emit_proto_text(self)

    def to_proto_text_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_proto_text())

    # ------------------------------------------------------------------- json
    @classmethod
    def from_json(cls, path_or_json: Union[str, dict]) -> "Schema":
        if isinstance(path_or_json, dict):
            payload = path_or_json
        elif "\n" in path_or_json or path_or_json.lstrip().startswith("{"):
            payload = json.loads(path_or_json)
        else:
            with open(path_or_json) as f:
                payload = json.load(f)
        return _schema_from_json_dict(cls, payload)

    def to_json(self) -> str:
        return json.dumps(_schema_to_json_dict(self), indent=2)

    def to_json_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Schema":
        if str(path).endswith(".json"):
            return cls.from_json(path)
        return cls.from_proto_text(path)


# ---------------------------------------------------------------------------
# Embedding-dim heuristic (reference: merlin_standard_lib/utils/embedding_utils.py:22-35)
# ---------------------------------------------------------------------------


def get_embedding_size_from_cardinality(cardinality: int, multiplier: float = 2.0) -> int:
    """``ceil(cardinality ** 0.25 * multiplier)`` — same rule as the reference."""
    return int(math.ceil(math.pow(cardinality, 0.25) * multiplier))


# ---------------------------------------------------------------------------
# proto-text subset parser / emitter
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<brace_open>\{)
  | (?P<brace_close>\})
  | (?P<colon>:)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<number>-?\d+\.?\d*(?:[eE][-+]?\d+)?)
  | (?P<ws>\s+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ValueError(f"Unexpected character in proto text at offset {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        yield kind, m.group()


def _parse_message(tokens, i):
    """Parse tokens into a nested dict; repeated fields become lists."""
    msg: Dict[str, object] = {}
    while i < len(tokens):
        kind, value = tokens[i]
        if kind == "brace_close":
            return msg, i + 1
        if kind != "ident":
            raise ValueError(f"Expected field name, got {value!r}")
        field = value
        i += 1
        if i >= len(tokens):
            raise ValueError(f"Truncated proto text after field {field!r}")
        kind2, value2 = tokens[i]
        if kind2 == "colon":
            i += 1
            if i >= len(tokens):
                raise ValueError(f"Truncated proto text after {field!r}:")
            kind2, value2 = tokens[i]
            if kind2 == "string":
                val = json.loads(value2)
            elif kind2 == "number":
                val = float(value2) if ("." in value2 or "e" in value2 or "E" in value2) else int(value2)
            elif kind2 == "ident":
                if value2 in ("true", "false"):
                    val = value2 == "true"
                else:
                    val = value2  # enum name
            else:
                raise ValueError(f"Unexpected value token {value2!r}")
            i += 1
        elif kind2 == "brace_open":
            val, i = _parse_message(tokens, i + 1)
        else:
            raise ValueError(f"Expected ':' or '{{' after {field!r}")
        if field in msg:
            prev = msg[field]
            if not isinstance(prev, list):
                msg[field] = [prev]
            msg[field].append(val)  # type: ignore[union-attr]
        else:
            msg[field] = val
    return msg, i


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _column_from_msg(feat: dict) -> ColumnSchema:
    col = ColumnSchema(name=feat.get("name", ""))
    col.type = FeatureType.parse(feat.get("type", 0))
    vc = feat.get("value_count") or feat.get("valueCount")
    if isinstance(vc, dict):
        col.value_count = ValueCount(int(vc.get("min", 0) or 0), int(vc.get("max", 0) or 0))
    shp = feat.get("shape") or feat.get("fixed_shape") or feat.get("fixedShape")
    if isinstance(shp, dict):
        dims = []
        for d in _as_list(shp.get("dim")):
            if isinstance(d, dict):
                dims.append(int(d.get("size", 0)))
            else:
                dims.append(int(d))
        col.shape = FixedShape(dims)
    idom = feat.get("int_domain") or feat.get("intDomain")
    if isinstance(idom, dict):
        col.int_domain = IntDomain(
            name=idom.get("name", col.name),
            min=int(idom.get("min", 0) or 0),
            max=int(idom.get("max", 0) or 0),
            is_categorical=bool(idom.get("is_categorical", idom.get("isCategorical", False))),
        )
    fdom = feat.get("float_domain") or feat.get("floatDomain")
    if isinstance(fdom, dict):
        col.float_domain = FloatDomain(
            name=fdom.get("name", col.name),
            min=float(fdom.get("min", 0.0) or 0.0),
            max=float(fdom.get("max", 0.0) or 0.0),
        )
    ann = feat.get("annotation")
    if isinstance(ann, dict):
        col.tags = [str(t) for t in _as_list(ann.get("tag"))]
        extra = ann.get("extra_metadata") or ann.get("extraMetadata")
        if extra:
            if isinstance(extra, str):
                # the pbtxt emitter stores the dict as a JSON string —
                # decode so round-trips are lossless (not double-wrapped)
                try:
                    decoded = json.loads(extra)
                    extra = decoded if isinstance(decoded, dict) else extra
                except (ValueError, TypeError):
                    pass
            col.extra_metadata = extra if isinstance(extra, dict) else {"raw": extra}
    return col


def _parse_proto_text(cls, text: str) -> Schema:
    tokens = list(_tokenize(text))
    msg, _ = _parse_message(tokens, 0)
    features = _as_list(msg.get("feature"))
    return cls([_column_from_msg(f) for f in features if isinstance(f, dict)])


def _emit_proto_text(schema: Schema) -> str:
    lines: List[str] = []
    for c in schema.columns:
        lines.append("feature {")
        lines.append(f'  name: "{c.name}"')
        if c.value_count is not None:
            lines.append("  value_count {")
            lines.append(f"    min: {c.value_count.min}")
            lines.append(f"    max: {c.value_count.max}")
            lines.append("  }")
        if c.shape is not None and c.shape.dims:
            lines.append("  shape {")
            for d in c.shape.dims:
                lines.append(f"    dim {{ size: {d} }}")
            lines.append("  }")
        if c.type:
            lines.append(f"  type: {FeatureType.name(c.type)}")
        if c.int_domain is not None:
            lines.append("  int_domain {")
            lines.append(f'    name: "{c.int_domain.name}"')
            lines.append(f"    min: {c.int_domain.min}")
            lines.append(f"    max: {c.int_domain.max}")
            if c.int_domain.is_categorical:
                lines.append("    is_categorical: true")
            lines.append("  }")
        if c.float_domain is not None:
            lines.append("  float_domain {")
            lines.append(f'    name: "{c.float_domain.name}"')
            lines.append(f"    min: {c.float_domain.min}")
            lines.append(f"    max: {c.float_domain.max}")
            lines.append("  }")
        if c.tags or c.extra_metadata:
            lines.append("  annotation {")
            for t in c.tags:
                lines.append(f'    tag: "{t}"')
            if c.extra_metadata:
                # round-trip annotation.extra_metadata as a JSON string —
                # silently dropping it would strip properties a downstream
                # Merlin consumer may rely on
                payload = json.dumps(c.extra_metadata, sort_keys=True)
                lines.append(f'    extra_metadata: {json.dumps(payload)}')
            lines.append("  }")
        lines.append("}")
        lines.append("")
    return "\n".join(lines)


def _schema_from_json_dict(cls, payload: dict) -> Schema:
    features = _as_list(payload.get("feature"))
    return cls([_column_from_msg(f) for f in features if isinstance(f, dict)])


def _schema_to_json_dict(schema: Schema) -> dict:
    feats = []
    for c in schema.columns:
        f: Dict[str, object] = {"name": c.name}
        if c.value_count is not None:
            f["valueCount"] = {"min": str(c.value_count.min), "max": str(c.value_count.max)}
        if c.shape is not None and c.shape.dims:
            f["shape"] = {"dim": [{"size": str(d)} for d in c.shape.dims]}
        if c.type:
            f["type"] = FeatureType.name(c.type)
        if c.int_domain is not None:
            f["intDomain"] = {
                "name": c.int_domain.name,
                "min": str(c.int_domain.min),
                "max": str(c.int_domain.max),
                **({"isCategorical": True} if c.int_domain.is_categorical else {}),
            }
        if c.float_domain is not None:
            f["floatDomain"] = {
                "name": c.float_domain.name,
                "min": c.float_domain.min,
                "max": c.float_domain.max,
            }
        if c.tags or c.extra_metadata:
            ann: Dict[str, object] = {}
            if c.tags:
                ann["tag"] = list(c.tags)
            if c.extra_metadata:
                ann["extra_metadata"] = dict(c.extra_metadata)
            f["annotation"] = ann
        feats.append(f)
    return {"feature": feats}


def requires_schema(module):
    """Mark a class (or instance) as schema-requiring (reference
    config/schema.py:69-72)."""
    module.REQUIRES_SCHEMA = True
    return module
