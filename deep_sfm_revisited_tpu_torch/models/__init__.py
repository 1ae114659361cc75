"""DICL flow, PSNet depth and the SFMNet composite of the port."""
