"""The gateway pieces the port's pool needs (the token bucket its admission
quotas reuse)."""
