"""`python -m spectre_tpu_torch.prover_service <cmd>` — delegates to
cli.main (`rpc` serves the JSON-RPC API, `scrub` runs one offline
artifact-scrubber pass)."""

from .cli import main

if __name__ == "__main__":
    main()
