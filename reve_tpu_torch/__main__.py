"""`python -m reve_tpu_torch` == the port's CLI (same surface as `reve`)."""

from reve_tpu_torch import cli

if __name__ == "__main__":
    cli.main()
