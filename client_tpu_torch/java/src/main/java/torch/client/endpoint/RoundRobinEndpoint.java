// Round-robin over several serving replicas (client-side LB).
// Parity role: the reference's endpoint abstraction exists exactly so
// deployments can plug LB policies in (ref src/java/.../endpoint/).
package torch.client.endpoint;

import java.util.ArrayList;
import java.util.List;
import java.util.concurrent.atomic.AtomicInteger;

public class RoundRobinEndpoint extends AbstractEndpoint {
  private final List<String> urls = new ArrayList<>();
  private final AtomicInteger cursor = new AtomicInteger();

  public RoundRobinEndpoint(List<String> endpoints) {
    for (String e : endpoints) {
      urls.add(e.contains("://") ? e : "http://" + e);
    }
    if (urls.isEmpty()) {
      throw new IllegalArgumentException("no endpoints provided");
    }
  }

  @Override
  public String next() {
    int i = Math.floorMod(cursor.getAndIncrement(), urls.size());
    return urls.get(i);
  }

  @Override
  public int size() {
    return urls.size();
  }
}
