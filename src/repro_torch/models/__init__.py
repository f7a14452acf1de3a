"""The paper's vision models and their layers."""
