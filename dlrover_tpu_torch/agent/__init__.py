"""Worker-side halves of the agent contract (the port's copies)."""
