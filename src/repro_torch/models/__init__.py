"""Model definitions of the port (the width-nested anytime LM)."""
