"""Monte-Carlo capture step."""
