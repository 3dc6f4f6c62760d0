"""MC-ELBO."""
