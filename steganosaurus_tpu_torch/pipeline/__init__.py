"""Embed/extract orchestration: the single-image path (embed.py,
extract.py, device.py), the batch path (batch.py, stream.py) and the wire
framing (header.py, spread.py, qim.py)."""
