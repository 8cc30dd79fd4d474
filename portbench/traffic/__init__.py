"""The traffic mixes (`<name>.json`) and the generator modules their
`kind` names (`<kind>.py`)."""
