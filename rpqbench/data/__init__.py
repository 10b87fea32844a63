"""Frozen copies of the inputs' generators (numpy only, seeded)."""
