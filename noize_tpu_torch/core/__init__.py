"""Tile geometry, StageIO payloads, the named buffer store and its serde."""
