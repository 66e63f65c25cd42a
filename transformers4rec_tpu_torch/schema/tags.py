"""Feature tag vocabulary.

Copy of the Merlin tag taxonomy consumed by the reference
(see merlin_standard_lib/schema/schema.py:135-143 — tags live in
``annotation.tag``). Tags drive all schema-based feature routing: categorical
columns get embedding tables, continuous columns get projections, the ITEM_ID
column feeds masking/label-generation and tied output weights.
"""

from __future__ import annotations

import enum


class Tags(str, enum.Enum):
    """Canonical column tags. Values are the lowercase strings stored in schema files."""

    # dtype-ish
    CATEGORICAL = "categorical"
    CONTINUOUS = "continuous"
    LIST = "list"
    TEXT = "text"
    TEXT_TOKENIZED = "text_tokenized"
    TIME = "time"

    # context
    USER = "user"
    ITEM = "item"
    SESSION = "session"
    CONTEXT = "context"

    # targets / ids
    ID = "id"
    ITEM_ID = "item_id"
    USER_ID = "user_id"
    SESSION_ID = "session_id"
    TARGET = "target"
    BINARY_CLASSIFICATION = "binary_classification"
    REGRESSION = "regression"

    # misc
    EMBEDDING = "embedding"

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value



def normalize_tag(tag) -> str:
    """Accept Tags enums, strings, or Merlin-style enum reprs and return the string value."""
    if isinstance(tag, Tags):
        return tag.value
    s = str(tag)
    # handle "Tags.ITEM_ID" style reprs
    if s.startswith("Tags."):
        s = s.split(".", 1)[1].lower()
    return s.lower()
