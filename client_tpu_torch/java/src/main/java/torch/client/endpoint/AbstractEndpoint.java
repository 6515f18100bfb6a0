// Client-side endpoint abstraction: each request asks for the next base
// URL, enabling client-side load balancing across serving replicas.
// Parity: ref src/java/.../endpoint/AbstractEndpoint.java.
package torch.client.endpoint;

public abstract class AbstractEndpoint {
  /** Next base URL to use (e.g. "http://host:8000"). */
  public abstract String next();

  /** Number of distinct endpoints behind this abstraction. */
  public abstract int size();
}
