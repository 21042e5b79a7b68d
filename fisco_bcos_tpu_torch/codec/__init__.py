"""Codecs: the deterministic wire and storage serialization."""

from .flat import FlatReader, FlatWriter  # noqa: F401
