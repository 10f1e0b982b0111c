"""U-Net, weights, flow dynamics and the segmenter."""
