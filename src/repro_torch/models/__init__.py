"""The paper's vision models, the language-model stack and their layers."""
