"""HMM solver classes."""
