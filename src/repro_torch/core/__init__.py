"""The FL algorithm: tree algebra, strategies, client selection and the loss."""
