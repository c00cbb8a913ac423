"""Model code of the port (dense GQA + MLP stack for serving)."""
