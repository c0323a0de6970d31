"""The 88th percentile (linear between order statistics) of the seconds
from when each request due in the window was due to when its image was
done on the card, over every such request (host clock); one not done
when the wait past the close ended counts with the seconds it had
waited. At the cell's rate a 50-second window holds some 90 requests,
so about ten lie beyond the 88th percentile and nine beyond the 90th."""
import numpy as np


def read(t):
    lat = t.get("latencies")
    return float(np.percentile(lat, 88)) if lat else None
