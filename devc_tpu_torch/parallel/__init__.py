"""Batched inference over several clips at once."""
