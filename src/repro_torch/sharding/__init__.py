"""Logical-axis sharding rules for DTensor placements (the reference's
``repro.sharding``)."""
